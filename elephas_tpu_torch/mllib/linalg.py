"""Minimal dense linear-algebra value types.

The reference's MLlib integration exchanges ``pyspark.mllib.linalg`` Vectors,
Matrices and ``LabeledPoint`` rows. This module provides standalone
equivalents so the adapter surface (``elephas/mllib/adapter.py:5-35``,
``elephas/utils/rdd_utils.py:23-85``) exists without a Spark dependency.
``DenseMatrix`` follows MLlib's column-major value layout.

A copy of ``elephas_tpu/mllib/linalg.py`` (numpy only).
"""
from typing import Sequence, Union

import numpy as np


class Vector:
    """Abstract dense vector."""


class Matrix:
    """Abstract dense matrix."""


class DenseVector(Vector):
    def __init__(self, values: Sequence[float]):
        self._values = np.asarray(values, dtype=np.float64).reshape(-1)

    def toArray(self) -> np.ndarray:
        return self._values.copy()

    def __len__(self) -> int:
        return self._values.shape[0]

    def __getitem__(self, idx):
        return self._values[idx]

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(self._values, other._values)

    def __repr__(self):
        return f"DenseVector({self._values.tolist()})"


class DenseMatrix(Matrix):
    """Column-major dense matrix (MLlib layout)."""

    def __init__(self, numRows: int, numCols: int, values: Sequence[float]):
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        if values.size != numRows * numCols:
            raise ValueError("values size does not match matrix dimensions")
        self.numRows = int(numRows)
        self.numCols = int(numCols)
        self._values = values

    def toArray(self) -> np.ndarray:
        return self._values.reshape((self.numRows, self.numCols), order="F").copy()

    def __repr__(self):
        return f"DenseMatrix({self.numRows}, {self.numCols})"


class Vectors:
    @staticmethod
    def dense(values: Sequence[float]) -> DenseVector:
        return DenseVector(values)


class Matrices:
    @staticmethod
    def dense(numRows: int, numCols: int, values: Sequence[float]) -> DenseMatrix:
        return DenseMatrix(numRows, numCols, values)


class LabeledPoint:
    """A labeled observation: scalar label plus a feature vector."""

    def __init__(self, label: float, features: Union[DenseVector, Sequence[float]]):
        label = np.asarray(label)
        self.label = float(label.item() if label.size == 1 else label)
        self.features = features if isinstance(features, DenseVector) else DenseVector(features)

    def __repr__(self):
        return f"LabeledPoint({self.label}, {self.features})"

    def __eq__(self, other):
        return (isinstance(other, LabeledPoint) and self.label == other.label
                and self.features == other.features)
