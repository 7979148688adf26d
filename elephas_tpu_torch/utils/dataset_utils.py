"""Dataset conversion utilities.

The counterpart of ``elephas_tpu/utils/dataset_utils.py``:
:func:`to_dataset` and :func:`encode_label`. The LabeledPoint helpers
wait for the port of ``mllib/`` (ROADMAP Queue 1 item 7).
"""
from typing import Optional

import numpy as np

from ..data.dataset import Dataset


def to_dataset(features: np.ndarray, labels: np.ndarray,
               num_partitions: Optional[int] = None) -> Dataset:
    """Build a feature/label pair Dataset from numpy arrays."""
    return Dataset((np.asarray(features), np.asarray(labels)),
                   num_partitions=num_partitions)


def encode_label(label, nb_classes: int) -> np.ndarray:
    """One-hot encode a single integer class label."""
    encoded = np.zeros(nb_classes)
    encoded[int(label)] = 1.0
    return encoded
