"""Data containers of the port."""
from .dataset import Dataset

__all__ = ["Dataset"]
