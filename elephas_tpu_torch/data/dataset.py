"""Partitioned in-memory dataset: the framework's RDD analog.

The counterpart of ``elephas_tpu/data/dataset.py`` for in-memory data:
columnar storage (aligned numpy arrays sharing the leading dimension)
or a list of row objects, contiguous and order-preserving partitioning
(``np.array_split`` semantics: partition sizes differ by at most one),
and the RDD-ish surface the trainers build on (``repartition``,
``partitions``, ``rows``, ``to_arrays``).

The default partition count is the number of visible CUDA devices (at
least 1); the JAX package's is ``jax.device_count()``. The file-backed
columns (``from_npy``, ``from_parquet``, ``from_parquet_dir``,
``ColumnSource``) are not ported yet (ROADMAP Queue 1 item 7).
"""
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _default_partitions() -> int:
    return max(1, torch.cuda.device_count())


class Dataset:
    """A partitioned dataset over aligned columns or a list of row objects.

    :param data: either a tuple/list of aligned numpy arrays (columnar
        storage; all sharing the leading dimension) or a list of arbitrary
        row objects.
    :param num_partitions: number of partitions; defaults to the number of
        visible CUDA devices (at least 1) at first use.
    """

    def __init__(self, data: Union[Tuple[np.ndarray, ...], List[Any]],
                 num_partitions: Optional[int] = None):
        if isinstance(data, tuple):
            columns = tuple(np.asarray(c) for c in data)
            if not columns:
                raise ValueError("Dataset needs at least one column")
            n = columns[0].shape[0]
            for c in columns:
                if c.shape[0] != n:
                    raise ValueError("all columns must share the leading dimension")
            self._columns: Optional[Tuple[np.ndarray, ...]] = columns
            self._rows: Optional[List[Any]] = None
            self._count = n
        else:
            self._columns = None
            self._rows = list(data)
            self._count = len(self._rows)
        self._num_partitions = num_partitions

    # -- construction --------------------------------------------------------
    @classmethod
    def from_arrays(cls, *columns: np.ndarray,
                    num_partitions: Optional[int] = None) -> "Dataset":
        return cls(tuple(columns), num_partitions=num_partitions)

    @classmethod
    def from_pairs(cls, pairs: Sequence[Tuple[Any, Any]],
                   num_partitions: Optional[int] = None) -> "Dataset":
        """Build a columnar dataset from an iterable of (x, y) row pairs."""
        pairs = list(pairs)
        xs = np.asarray([p[0] for p in pairs])
        ys = np.asarray([p[1] for p in pairs])
        return cls((xs, ys), num_partitions=num_partitions)

    # -- properties ----------------------------------------------------------
    @property
    def is_columnar(self) -> bool:
        return self._columns is not None

    @property
    def columns(self) -> Tuple[np.ndarray, ...]:
        if self._columns is None:
            raise ValueError("row-object dataset has no columnar view")
        return self._columns

    @property
    def num_partitions(self) -> int:
        if self._num_partitions is None:
            self._num_partitions = _default_partitions()
        return self._num_partitions

    def count(self) -> int:
        return self._count

    def __len__(self) -> int:
        return self._count

    # -- RDD-like surface ----------------------------------------------------
    def repartition(self, num_partitions: int) -> "Dataset":
        """Return a dataset with a new partition count (contiguous split)."""
        if self._columns is not None:
            return Dataset(self._columns, num_partitions=num_partitions)
        return Dataset(self._rows, num_partitions=num_partitions)

    def map_rows(self, fn) -> "Dataset":
        """Apply ``fn`` to every row, yielding a row-object dataset."""
        return Dataset([fn(row) for row in self.rows()], self._num_partitions)

    def rows(self) -> List[Any]:
        """Materialize rows: tuples for columnar data, objects otherwise."""
        if self._columns is not None:
            if len(self._columns) == 1:
                return [self._columns[0][i] for i in range(self._count)]
            return [tuple(c[i] for c in self._columns) for i in range(self._count)]
        return list(self._rows)

    def collect(self) -> List[Any]:
        return self.rows()

    def first(self) -> Any:
        if self._count == 0:
            raise ValueError("empty dataset")
        if self._columns is not None:
            if len(self._columns) == 1:
                return self._columns[0][0]
            return tuple(c[0] for c in self._columns)
        return self._rows[0]

    # -- partitioning --------------------------------------------------------
    def partition_sizes(self) -> List[int]:
        """Contiguous partition sizes (differ by at most one)."""
        n, p = self._count, self.num_partitions
        base, extra = divmod(n, p)
        return [base + (1 if i < extra else 0) for i in range(p)]

    def partition_bounds(self) -> List[Tuple[int, int]]:
        bounds = []
        start = 0
        for size in self.partition_sizes():
            bounds.append((start, start + size))
            start += size
        return bounds

    def partitions(self) -> List[Any]:
        """List of partition contents (columnar slices or row sublists)."""
        out = []
        for lo, hi in self.partition_bounds():
            if self._columns is not None:
                out.append(tuple(c[lo:hi] for c in self._columns))
            else:
                out.append(self._rows[lo:hi])
        return out

    def to_arrays(self) -> Tuple[np.ndarray, ...]:
        """Columnar view as numpy arrays (features, labels, ...)."""
        return self.columns
