"""Model <-> dict serialization for shipping models to workers.

The counterpart of ``elephas_tpu/utils/serialization.py``.
"""
from typing import Any, Dict, Optional

from .._device import DeviceLike


def model_to_dict(model) -> Dict[str, Any]:
    """Turn a model into ``{'model': <json arch>, 'weights': <array list>}``."""
    return dict(model=model.to_json(), weights=model.get_weights())


def dict_to_model(_dict: Dict[str, Any],
                  custom_objects: Optional[Dict[str, Any]] = None,
                  device: DeviceLike = None):
    """Rebuild a model from :func:`model_to_dict` output, on ``device``."""
    from ..models.core import model_from_json

    model = model_from_json(_dict["model"], custom_objects, device)
    if not model.built:
        model.build()
    model.set_weights(_dict["weights"])
    return model
