"""int8 delta compression for the parameter-server wire.

Async/hogwild training pushes weight DELTAS to the parameter server —
per push, per worker, per window. Over DCN (the multi-host transport,
SURVEY.md §2.3) those pushes are the bandwidth bill, and deltas tolerate
aggressive quantization: per-tensor absmax int8 cuts the wire bytes ~4x
vs float32 while :class:`ErrorFeedback` keeps training unbiased — each
worker carries the quantization error forward into its next push
(EF-SGD), so rounding noise averages out instead of accumulating.

The quantized frame is ordinary codec currency (``KIND_DELTA_Q8``:
interleaved ``[int8 data, float32 scale, ...]`` pairs), so the native
C++ codec and framing handle it unchanged.

The reference ships raw pickled float arrays
(``elephas/parameter/client.py:54-63``) — no compression anywhere.

Copied into the port from ``elephas_tpu/utils/delta_compression.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["quantize_delta", "dequantize_delta", "ErrorFeedback"]


def quantize_delta(delta: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Per-tensor absmax int8: ``[q_0, scale_0, q_1, scale_1, ...]``.
    Scales are shape-(1,) float32; an all-zero tensor gets scale 0."""
    out: List[np.ndarray] = []
    for a in delta:
        a32 = np.asarray(a, np.float32)
        amax = float(np.max(np.abs(a32))) if a32.size else 0.0
        scale = np.float32(amax / 127.0)
        if scale > 0:
            q = np.clip(np.rint(a32 / scale), -127, 127).astype(np.int8)
        else:
            q = np.zeros(a32.shape, np.int8)
        out.append(q)
        out.append(np.asarray([scale], np.float32))
    return out


def dequantize_delta(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Inverse of :func:`quantize_delta`."""
    if len(arrays) % 2:
        raise ValueError("quantized delta frame must hold (data, scale) "
                         f"pairs, got {len(arrays)} arrays")
    out = []
    for q, scale in zip(arrays[0::2], arrays[1::2]):
        out.append(q.astype(np.float32) * np.float32(scale.reshape(())))
    return out


class ErrorFeedback:
    """EF-SGD residual carrier for one worker's compressed pushes.

    ``apply(delta)`` returns the delta to hand the (compressing) client:
    the raw delta plus the residual of every previous push's
    quantization. The residual is computed against the exact
    quantize/dequantize pair the client will apply, so what the server
    accumulates over time equals the sum of the raw deltas up to one
    bounded residual — quantization noise does not bias training.
    """

    def __init__(self):
        self._residual: Optional[List[np.ndarray]] = None
        #: the quantized frame for the last ``apply`` call — senders
        #: reuse it directly (one quantization pass total, not one here
        #: plus one in the client)
        self.last_frame: Optional[List[np.ndarray]] = None
        #: what the server will actually apply for the last ``apply``
        #: call (the dequantized push) — consumers that track in-flight
        #: deltas (the overlapped worker's snapshot correction) need the
        #: applied values, not the requested ones
        self.last_on_wire: Optional[List[np.ndarray]] = None

    def apply(self, delta: Sequence[np.ndarray]) -> List[np.ndarray]:
        delta = [np.asarray(d, np.float32) for d in delta]
        if self._residual is not None:
            delta = [d + r for d, r in zip(delta, self._residual)]
        self.last_frame = quantize_delta(delta)
        self.last_on_wire = dequantize_delta(self.last_frame)
        self._residual = [d - w for d, w in zip(delta, self.last_on_wire)]
        return delta
