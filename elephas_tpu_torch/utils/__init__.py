"""Host-side utilities of the port."""
from .dataset_utils import encode_label, to_dataset
from .serialization import dict_to_model, model_to_dict

__all__ = ["to_dataset", "encode_label", "model_to_dict", "dict_to_model"]
