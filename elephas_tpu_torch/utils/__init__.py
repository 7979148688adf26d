"""Host-side utilities of the port."""
from .dataset_utils import (encode_label, from_labeled_points,
                            lp_to_dataset, to_dataset, to_labeled_points)
from .serialization import dict_to_model, model_to_dict

__all__ = ["to_dataset", "encode_label", "to_labeled_points",
           "from_labeled_points", "lp_to_dataset", "model_to_dict",
           "dict_to_model"]
