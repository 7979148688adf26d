"""The model stack of the port: the transformer LM, its optimizers and
the TransformerModel training entry point."""
