"""MLlib-style dense linear-algebra types and their numpy adapters
(the counterpart of ``elephas_tpu/mllib``)."""
from .adapter import from_matrix, from_vector, to_matrix, to_vector
from .linalg import (DenseMatrix, DenseVector, LabeledPoint, Matrices, Matrix,
                     Vector, Vectors)
