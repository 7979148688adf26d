"""The inference model stack of the port."""
