"""Host-to-device input prefetching.

The counterpart of ``elephas_tpu/utils/prefetch.py``.
``prefetch_to_device`` walks an iterator of host batches (numpy arrays,
or tuples and lists of them) and keeps ``size`` items' copies to the
device in flight ahead of the consumer, so batch ``i+1``'s copy
overlaps batch ``i``'s compute.

On a CUDA device each array is staged in pinned host memory and copied
with ``non_blocking=True`` on the device's current stream, the stream
the consumer computes on, so the consumer's kernels are ordered after
the copy and never read a buffer still being written. The pinned
sources stay referenced, with an event recorded after their copies,
until that event has completed; the generator waits on the events still
pending when it ends or is closed. On the CPU the items come back as
tensors over the same memory, with no copy.
"""
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["prefetch_to_device"]


def _map(fn, item):
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    return fn(item)


def prefetch_to_device(iterable: Iterable, size: int = 2,
                       device: DeviceLike = None) -> Iterator:
    """Yield the items of ``iterable`` as tensors on ``device`` (``None``
    means the CUDA device), keeping up to ``size`` copies in flight
    ahead of the consumer. Order is preserved; ``size=0`` copies each
    item just before it is yielded."""
    if size < 0:
        raise ValueError("size must be >= 0")
    device = resolve_device(device)
    if device.type != "cuda":
        for item in iterable:
            yield _map(lambda a: torch.as_tensor(np.asarray(a)), item)
        return

    stream = torch.cuda.current_stream(device)
    in_flight = deque()   # (event, pinned sources) of copies not yet seen done

    def put(item):
        staged = []

        def copy(a):
            host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            staged.append(host)
            return host.to(device, non_blocking=True)

        out = _map(copy, item)
        done = torch.cuda.Event()
        done.record(stream)
        in_flight.append((done, staged))
        return out

    def release():
        while in_flight and in_flight[0][0].query():
            in_flight.popleft()

    ahead = deque()
    try:
        for item in iterable:
            ahead.append(put(item))
            if len(ahead) > size:
                yield ahead.popleft()
                release()
        while ahead:
            yield ahead.popleft()
            release()
    finally:
        for done, _ in in_flight:
            done.synchronize()
