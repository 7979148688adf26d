"""Typed, length-prefixed binary wire format for tensor payloads.

The reference ships weights between workers and its parameter server as
pickled Python objects over HTTP/TCP (``elephas/utils/sockets.py:45-71``,
``elephas/parameter/client.py:54-91``). Pickle is unsafe to deserialize from
the network and slow. This module replaces it with a typed tensor protocol:

    header:  magic b"ETPU" | u8 version | u8 kind | u32 count
    per tensor: u8 dtype-code | u8 ndim | u64[ndim] dims | raw little-endian bytes

``kind`` distinguishes payload semantics (plain weight list, delta list,
scalar metadata, Q8-compressed deltas, and the disaggregated-serving KV
frames — fp or Q8 — of :mod:`elephas_tpu.disagg.wire`). The codec
round-trips a flat list of numpy arrays — the currency of the
parameter-server layer and the KV-transfer wire — without executing any
embedded code.

A C++ implementation of the same format (``native/tensor_codec.cpp``) is used
when built; this module is the canonical specification and pure-Python
fallback.

Copied into the port from ``elephas_tpu/utils/tensor_codec.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import struct
from typing import List, Sequence

import numpy as np

MAGIC = b"ETPU"
VERSION = 1

#: refuse frames above this size — a corrupt length prefix must not drive a
#: multi-GB allocation. Shared by the Python and native transports.
MAX_FRAME_BYTES = 1 << 34

KIND_WEIGHTS = 0
KIND_DELTA = 1
KIND_SCALARS = 2
#: int8-quantized delta: interleaved (int8 data, float32 scale) pairs —
#: see :mod:`elephas_tpu.utils.delta_compression`
KIND_DELTA_Q8 = 3
#: KV-transfer frame (disaggregated prefill -> decode): one uint8 JSON
#: metadata tensor followed by the per-layer paged KV block tensors —
#: see :mod:`elephas_tpu.disagg.wire`
KIND_KV = 4
#: Q8 KV-transfer frame: metadata tensor followed by interleaved
#: (int8 data, float32 scale) block pairs
#: (:func:`elephas_tpu.models.quantization.quantize_kv_frames`)
KIND_KV_Q8 = 5

_DTYPE_CODES = {
    np.dtype("float32"): 0,
    np.dtype("float64"): 1,
    np.dtype("int32"): 2,
    np.dtype("int64"): 3,
    np.dtype("uint8"): 4,
    np.dtype("bool"): 5,
    np.dtype("float16"): 6,
    np.dtype("int8"): 7,
    np.dtype("uint32"): 8,
    np.dtype("uint64"): 9,
}
try:  # ml_dtypes provides bfloat16 as a numpy extension dtype
    import ml_dtypes  # noqa: F401

    _DTYPE_CODES[np.dtype(ml_dtypes.bfloat16)] = 10
except Exception:  # pragma: no cover - optional
    pass

_CODE_DTYPES = {}
for _dt, _code in _DTYPE_CODES.items():
    _CODE_DTYPES.setdefault(_code, _dt)


class CodecError(ValueError):
    pass


def alloc_frame(nbytes: int) -> memoryview:
    """A writable buffer of ``nbytes`` UNINITIALIZED bytes — the frame
    allocator shared by every encode/receive path (Python and native).

    ``bytearray(n)`` zero-fills: ~55 ms per 64 MB, GIL-held, paid on
    EVERY frame allocation even though the codec/socket contract
    guarantees every byte is subsequently written (encode computes the
    exact frame size up front and fills it; ``recv_exact`` /
    ``recv_frame_native`` read until full). ``np.empty`` skips the
    memset, and the returned memoryview is bytes-like everywhere the
    old bytearray went: ``sendall``/HTTP bodies, ``struct.pack_into``,
    ``recv_into``, ``frombuffer`` views, slicing, ``len``. Measured on
    the PS plane: +42% single-server / +21% sharded round throughput at
    64 MB (``benchmarks/ps_rpc_bench.py``).

    The ownership story, both languages: the ALLOCATOR's caller owns
    the buffer and must fill every byte before handing it to a reader —
    uninitialized bytes are never observable unless a producer violates
    its size contract (the native side documents the same invariant on
    ``etpu_encode``/``etpu_recv_frame_body``)."""
    return memoryview(np.empty(int(nbytes), dtype=np.uint8))


def _normalize(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Wire-ready views of the inputs: supported dtype, C-contiguous.
    Arrays that already qualify pass through untouched (zero copies);
    non-contiguous inputs (Fortran order, strided slices) go through an
    explicit ``ascontiguousarray`` fallback."""
    norm = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.dtype not in _DTYPE_CODES:
            arr = arr.astype(np.float32)
        if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        norm.append(arr)
    return norm


def encode_tensors(arrays: Sequence[np.ndarray],
                   kind: int = KIND_WEIGHTS) -> memoryview:
    """Serialize a list of numpy arrays into the ETPU wire format.

    Single-allocation encode: the total frame size is computed up
    front, one uninitialized buffer is allocated (:func:`alloc_frame` —
    no ``bytearray`` memset; every byte below is written), and each
    tensor's bytes are written straight into it through a
    ``frombuffer`` view — no per-array ``tobytes()`` intermediate
    copies. Returns a writable ``memoryview`` (bytes-like for
    ``sendall``/HTTP bodies without a further copy)."""
    norm = _normalize(arrays)
    total = 10
    for arr in norm:
        total += 2 + 8 * arr.ndim + arr.nbytes
    buf = alloc_frame(total)
    buf[0:4] = MAGIC
    struct.pack_into("<BBI", buf, 4, VERSION, kind, len(norm))
    offset = 10
    for arr in norm:
        struct.pack_into("<BB", buf, offset, _DTYPE_CODES[arr.dtype],
                         arr.ndim)
        offset += 2
        if arr.ndim:
            struct.pack_into("<%dQ" % arr.ndim, buf, offset, *arr.shape)
            offset += 8 * arr.ndim
        if arr.nbytes:
            np.frombuffer(buf, dtype=arr.dtype, count=arr.size,
                          offset=offset)[...] = arr.reshape(-1)
            offset += arr.nbytes
    return buf


def decode_tensors(payload, copy: bool = True) -> tuple:
    """Deserialize an ETPU payload. Returns ``(arrays, kind)``.

    With ``copy=False`` the returned arrays are zero-copy VIEWS of
    ``payload`` (they alias its memory and keep it alive): mutating a
    ``bytearray`` payload mutates the arrays, and views of immutable
    ``bytes`` are read-only. Callers choosing view mode must treat the
    arrays as frozen snapshots — the receive-path contract."""
    if len(payload) < 10 or payload[:4] != MAGIC:
        raise CodecError("not an ETPU payload")
    version, kind, count = struct.unpack_from("<BBI", payload, 4)
    if version != VERSION:
        raise CodecError(f"unsupported ETPU version {version}")
    offset = 10
    arrays: List[np.ndarray] = []
    for _ in range(count):
        if offset + 2 > len(payload):
            raise CodecError("truncated tensor header")
        code, ndim = struct.unpack_from("<BB", payload, offset)
        offset += 2
        if code not in _CODE_DTYPES:
            raise CodecError(f"unknown dtype code {code}")
        if offset + 8 * ndim > len(payload):
            raise CodecError("truncated shape header")
        dims = struct.unpack_from("<%dQ" % ndim, payload, offset)
        offset += 8 * ndim
        dtype = _CODE_DTYPES[code]
        count_elems = 1
        for d in dims:  # python ints: no silent overflow on hostile dims
            count_elems *= d
        if count_elems > (1 << 40):
            raise CodecError("tensor too large / hostile dims")
        nbytes = count_elems * dtype.itemsize
        if offset + nbytes > len(payload):
            raise CodecError("truncated tensor body")
        if nbytes:
            arr = np.frombuffer(payload, dtype=dtype, count=count_elems,
                                offset=offset).reshape(dims)
        else:
            arr = np.empty(dims, dtype=dtype)
        offset += nbytes
        arrays.append(arr.copy() if copy else arr)
    return arrays, kind


def encode(arrays: Sequence[np.ndarray], kind: int = KIND_WEIGHTS) -> bytes:
    """Encode, preferring the native C++ implementation when built."""
    try:
        from . import native

        out = native.encode_tensors_native(arrays, kind)
        if out is not None:
            return out
    except CodecError:
        raise
    except Exception:
        pass
    return encode_tensors(arrays, kind)


def decode(payload, copy: bool = True) -> tuple:
    """Decode, preferring the native C++ implementation when built.
    ``copy=False`` returns arrays viewing ``payload`` (see
    :func:`decode_tensors`)."""
    try:
        from . import native

        out = native.decode_tensors_native(payload, copy=copy)
        if out is not None:
            return out
    except CodecError:
        raise
    except Exception:
        pass
    return decode_tensors(payload, copy=copy)


def encode_weights(weights: Sequence[np.ndarray]) -> bytes:
    return encode(weights, KIND_WEIGHTS)


def decode_weights(payload, copy: bool = True) -> List[np.ndarray]:
    """``copy=False`` returns views of ``payload`` (writable only when
    the payload is a mutable buffer — views of ``bytes`` are
    read-only); see :func:`decode_tensors`."""
    arrays, _ = decode(payload, copy=copy)
    return arrays
