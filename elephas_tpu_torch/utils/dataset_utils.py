"""Dataset conversion utilities.

The counterpart of ``elephas_tpu/utils/dataset_utils.py`` (numpy only):
:func:`to_dataset`, :func:`encode_label` and the LabeledPoint helpers
(:func:`to_labeled_points`, :func:`from_labeled_points`,
:func:`lp_to_dataset`). ``tokens_to_sequences`` is not here yet.
"""
from typing import Optional, Tuple

import numpy as np

from ..data.dataset import Dataset
from ..mllib.adapter import from_vector, to_vector
from ..mllib.linalg import LabeledPoint


def to_dataset(features: np.ndarray, labels: np.ndarray,
               num_partitions: Optional[int] = None) -> Dataset:
    """Build a feature/label pair Dataset from numpy arrays."""
    return Dataset((np.asarray(features), np.asarray(labels)),
                   num_partitions=num_partitions)


def to_labeled_points(features: np.ndarray, labels: np.ndarray,
                      categorical: bool = False,
                      num_partitions: Optional[int] = None) -> Dataset:
    """Convert numpy arrays into a Dataset of LabeledPoint rows.

    One-hot labels are collapsed with argmax when ``categorical`` is set
    (parity: ``elephas/utils/rdd_utils.py:23-35``).
    """
    points = [LabeledPoint(np.argmax(y) if categorical else y,
                           to_vector(np.asarray(x)))
              for x, y in zip(features, labels)]
    return Dataset(points, num_partitions=num_partitions)


def from_labeled_points(dataset: Dataset, categorical: bool = False,
                        nb_classes: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Convert a LabeledPoint Dataset back to numpy feature/label arrays.

    Labels are re-one-hot-encoded when ``categorical`` is set; the class
    count is inferred as ``max(label) + 1`` when not supplied (parity:
    ``elephas/utils/rdd_utils.py:38-55``).
    """
    rows = dataset.rows()
    features = np.array([from_vector(lp.features) for lp in rows])
    if categorical:
        labels = np.array([int(lp.label) for lp in rows])
        if not nb_classes:
            nb_classes = int(np.max(labels)) + 1
        labels = np.stack([encode_label(label, nb_classes)
                           for label in labels])
    else:
        labels = np.array([lp.label for lp in rows])
    return features, labels


def encode_label(label, nb_classes: int) -> np.ndarray:
    """One-hot encode a single integer class label."""
    encoded = np.zeros(nb_classes)
    encoded[int(label)] = 1.0
    return encoded


def lp_to_dataset(lp_dataset: Dataset, categorical: bool = False,
                  nb_classes: Optional[int] = None) -> Dataset:
    """Convert a LabeledPoint Dataset into a feature/label pair Dataset
    (parity: ``lp_to_simple_rdd``, ``elephas/utils/rdd_utils.py:70-85``)."""
    rows = lp_dataset.rows()
    features = np.array([from_vector(lp.features) for lp in rows])
    if categorical:
        if not nb_classes:
            nb_classes = int(max(int(lp.label) for lp in rows)) + 1
        labels = np.stack([encode_label(lp.label, nb_classes)
                           for lp in rows])
    else:
        labels = np.array([lp.label for lp in rows])
    return Dataset((features, labels),
                   num_partitions=lp_dataset._num_partitions)
