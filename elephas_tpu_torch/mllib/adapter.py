"""numpy <-> dense linalg adapters (parity: ``elephas/mllib/adapter.py:5-35``).

A copy of ``elephas_tpu/mllib/adapter.py`` (numpy only).
"""
import numpy as np

from .linalg import DenseMatrix, DenseVector, Matrices, Matrix, Vector, Vectors


def from_matrix(matrix: Matrix) -> np.ndarray:
    """Convert a dense Matrix to a numpy array."""
    return matrix.toArray()


def to_matrix(np_array: np.ndarray) -> DenseMatrix:
    """Convert a 2-D numpy array to a dense Matrix."""
    if len(np_array.shape) == 2:
        return Matrices.dense(np_array.shape[0], np_array.shape[1],
                              np_array.ravel(order="F"))
    raise Exception("A Matrix can only be created from a two-dimensional "
                    "numpy array, got {}".format(len(np_array.shape)))


def from_vector(vector: Vector) -> np.ndarray:
    """Convert a dense Vector to a numpy array."""
    return vector.toArray()


def to_vector(np_array: np.ndarray) -> DenseVector:
    """Convert a 1-D numpy array to a dense Vector."""
    if len(np_array.shape) == 1:
        return Vectors.dense(np_array)
    raise Exception("A Vector can only be created from a one-dimensional "
                    "numpy array, got {}".format(len(np_array.shape)))
