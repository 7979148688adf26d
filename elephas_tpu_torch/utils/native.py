"""ctypes bindings for the native ETPU codec (``native/etpu_codec.cpp``).

The Python codec in :mod:`.tensor_codec` is the canonical spec and always
available; this module loads the C++ implementation when built (run
``native/build.sh`` or :func:`build`) and exposes byte-identical
encode/decode plus single-syscall-loop framed socket I/O. The parameter
server layer uses it transparently when present.

Copied into the port from ``elephas_tpu/utils/native.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies.
"""
import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tensor_codec import (_CODE_DTYPES, _DTYPE_CODES, CodecError,
                           KIND_WEIGHTS, MAX_FRAME_BYTES, alloc_frame)

_LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / "libetpu.so"
_lib = None


def _stale() -> bool:
    """True when libetpu.so is older than any native source file."""
    if not _LIB_PATH.exists():
        return True
    lib_mtime = _LIB_PATH.stat().st_mtime
    sources = list(_LIB_PATH.parent.glob("*.cpp")) + [
        _LIB_PATH.parent / "build.sh"]
    return any(s.exists() and s.stat().st_mtime > lib_mtime for s in sources)


def build(force: bool = False) -> bool:
    """Compile the native library with g++ when missing or out of date;
    returns True on success.

    Compiles to a temp name and renames over the target: the .so may be
    dlopened by this (or another) process, and rewriting the mapped inode
    in place could SIGBUS it — rename gives readers the old inode until
    they reload.
    """
    global _lib
    if not force and not _stale():
        return True
    script = _LIB_PATH.parent / "build.sh"
    tmp_name = f"{_LIB_PATH.name}.tmp.{os.getpid()}"
    try:
        subprocess.run(["sh", str(script), tmp_name], check=True,
                       capture_output=True)
        os.replace(_LIB_PATH.parent / tmp_name, _LIB_PATH)
        _lib = None  # force a fresh CDLL of the new inode on next _load
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        try:
            (_LIB_PATH.parent / tmp_name).unlink()
        except OSError:
            pass
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.etpu_encoded_size.restype = ctypes.c_int64
    lib.etpu_encoded_size.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                      ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.etpu_encode.restype = ctypes.c_int32
    lib.etpu_encode.argtypes = [ctypes.c_int32,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.c_uint8, ctypes.c_char_p]
    lib.etpu_decode_probe.restype = ctypes.c_int32
    lib.etpu_decode_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.POINTER(ctypes.c_uint8)]
    lib.etpu_decode_describe.restype = ctypes.c_int32
    lib.etpu_decode_describe.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         ctypes.POINTER(ctypes.c_int64)]
    lib.etpu_send_frame.restype = ctypes.c_int32
    # accept any buffer (bytes OR the zero-copy bytearray encode returns)
    lib.etpu_send_frame.argtypes = [ctypes.c_int32, ctypes.c_void_p,
                                    ctypes.c_int64]
    lib.etpu_recv_frame_len.restype = ctypes.c_int64
    lib.etpu_recv_frame_len.argtypes = [ctypes.c_int32]
    lib.etpu_recv_frame_body.restype = ctypes.c_int32
    lib.etpu_recv_frame_body.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                         ctypes.c_int64]
    if hasattr(lib, "etpu_loader_create"):  # absent in pre-loader builds
        lib.etpu_loader_create.restype = ctypes.c_void_p
        lib.etpu_loader_create.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int32]
        lib.etpu_loader_next.restype = ctypes.c_int64
        lib.etpu_loader_next.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
        lib.etpu_loader_destroy.restype = None
        lib.etpu_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _describe_arrays(arrays: Sequence[np.ndarray]):
    normalized = []
    codes = bytearray()
    ndims = bytearray()
    dims: List[int] = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.dtype not in _DTYPE_CODES:
            arr = arr.astype(np.float32)
        if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        normalized.append(arr)
        codes.append(_DTYPE_CODES[arr.dtype])
        ndims.append(arr.ndim)
        dims.extend(int(d) for d in arr.shape)
    dims_arr = (ctypes.c_uint64 * max(len(dims), 1))(*dims)
    return normalized, bytes(codes), bytes(ndims), dims_arr


def encode_tensors_native(arrays: Sequence[np.ndarray],
                          kind: int = KIND_WEIGHTS
                          ) -> Optional[memoryview]:
    """Native encode; returns None when the library is unavailable.
    The output buffer is allocated UNINITIALIZED (``alloc_frame`` — no
    memset of bytes ``etpu_encode`` writes in full; the C side
    documents the same every-byte-written contract)."""
    lib = _load()
    if lib is None:
        return None
    arrays, codes, ndims, dims = _describe_arrays(arrays)
    size = lib.etpu_encoded_size(len(arrays), codes, ndims, dims)
    if size < 0:
        raise CodecError("native encode: bad dtype")
    out = alloc_frame(size)
    buf = (ctypes.c_char * size).from_buffer(out)
    ptrs = (ctypes.c_void_p * max(len(arrays), 1))()
    for i, arr in enumerate(arrays):
        ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p)
    if lib.etpu_encode(len(arrays), ptrs, codes, ndims, dims, kind, buf) != 0:
        raise CodecError("native encode failed")
    del buf  # release the exported buffer so the memoryview is usable
    return out  # bytes-like for sendall/urllib without a copy


def decode_tensors_native(payload,
                          copy: bool = True
                          ) -> Optional[Tuple[List[np.ndarray], int]]:
    """Native decode of ``bytes`` or ``bytearray`` (the zero-copy receive
    path); returns None when the library is unavailable. ``copy=False``
    returns arrays that VIEW ``payload`` in place (same aliasing
    contract as :func:`~elephas_tpu.utils.tensor_codec.decode_tensors`)."""
    lib = _load()
    if lib is None:
        return None
    if isinstance(payload, (bytearray, memoryview)):
        # writable buffers (the zero-copy receive path returns
        # memoryviews): c_char arrays decay to c_char_p params without
        # copying; read-only memoryviews (rare) fall back to one copy
        if isinstance(payload, memoryview) and payload.readonly:
            payload = bytes(payload)
            raw = payload
        else:
            raw = (ctypes.c_char * len(payload)).from_buffer(payload)
    else:
        raw = payload
    count = ctypes.c_int32()
    total_dims = ctypes.c_int32()
    kind = ctypes.c_uint8()
    rc = lib.etpu_decode_probe(raw, len(payload), ctypes.byref(count),
                               ctypes.byref(total_dims), ctypes.byref(kind))
    if rc != 0:
        raise CodecError(f"native decode: malformed payload (code {rc})")
    n = count.value
    codes = ctypes.create_string_buffer(max(n, 1))
    ndims = ctypes.create_string_buffer(max(n, 1))
    dims = (ctypes.c_uint64 * max(total_dims.value, 1))()
    offsets = (ctypes.c_int64 * max(n, 1))()
    lib.etpu_decode_describe(raw, len(payload), codes, ndims, dims, offsets)
    arrays = []
    dim_pos = 0
    for i in range(n):
        code = codes.raw[i]
        ndim = ndims.raw[i]
        shape = tuple(dims[dim_pos:dim_pos + ndim])
        dim_pos += ndim
        dtype = _CODE_DTYPES[code]
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        start = offsets[i]
        # frombuffer views the payload in place; copy=True materializes
        # one owned allocation per tensor, copy=False hands the view out
        arr = np.frombuffer(payload, dtype=dtype, count=count,
                            offset=start).reshape(shape)
        arrays.append(arr.copy() if copy else arr)
    return arrays, kind.value


def send_frame_native(fd: int, payload) -> bool:
    """Send one frame; ``payload`` may be bytes, bytearray, or the
    writable memoryview the zero-copy encoder returns (all zero
    copy)."""
    lib = _load()
    if lib is None:
        return False
    if (isinstance(payload, (bytearray, memoryview))
            and not getattr(payload, "readonly", False)):
        buf = (ctypes.c_char * len(payload)).from_buffer(payload)
        rc = lib.etpu_send_frame(fd, ctypes.cast(buf, ctypes.c_void_p),
                                 len(payload))
        del buf
    else:
        data = bytes(payload)  # held alive for the duration of the call
        rc = lib.etpu_send_frame(fd, data, len(data))
    if rc != 0:
        raise ConnectionError("native send_frame failed")
    return True


class NativeBatchLoader:
    """Background-prefetched shuffled batch iterator over aligned columns.

    Wraps the C++ producer thread in ``native/etpu_loader.cpp``: batch N+1
    gathers on a worker thread while the caller consumes batch N. The
    random-access shuffle gather (the expensive part) happens off-thread;
    by default each batch is then copied out of the ring buffer so the
    yielded arrays are ordinarily-owned numpy arrays. ``copy=False`` yields
    zero-copy views instead — valid ONLY until the next iteration (safe
    for fit loops, where the device transfer happens at step dispatch, but
    not for ``list(loader)``).
    """

    def __init__(self, columns, order, batch_size: int, depth: int = 3,
                 copy: bool = True):
        self._copy = copy
        lib = _load()
        if lib is None or not hasattr(lib, "etpu_loader_create"):
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        # keep the borrowed arrays alive for the loader's lifetime
        self._columns = [np.ascontiguousarray(c) for c in columns]
        self._order = np.ascontiguousarray(order, dtype=np.uint64)
        nrows = self._columns[0].shape[0]
        if any(c.shape[0] != nrows for c in self._columns):
            raise ValueError("columns must share the leading dimension")
        # order may address any subset/permutation of the rows
        if len(self._order) and int(self._order.max()) >= nrows:
            raise ValueError("order index out of range")
        self.batch_size = int(batch_size)
        ncols = len(self._columns)
        ptrs = (ctypes.c_void_p * ncols)(
            *[c.ctypes.data_as(ctypes.c_void_p).value for c in self._columns])
        row_bytes = (ctypes.c_uint64 * ncols)(
            *[c.dtype.itemsize * int(np.prod(c.shape[1:], dtype=np.int64))
              for c in self._columns])
        self._handle = lib.etpu_loader_create(
            ncols, ptrs, row_bytes, len(self._order),
            self._order.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self.batch_size, depth)
        if self._handle is None:
            if len(self._order) == 0:
                self._handle = None  # served as an empty iterator
            else:
                raise RuntimeError("etpu_loader_create failed")
        self._out = (ctypes.c_void_p * ncols)()

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        rows = self._lib.etpu_loader_next(self._handle, self._out)
        if rows < 0:
            self.close()
            raise RuntimeError("native loader failed")
        if rows == 0:
            self.close()
            raise StopIteration
        batch = []
        for c, ptr in zip(self._columns, self._out):
            shape = (int(rows),) + c.shape[1:]
            count = int(rows) * int(np.prod(c.shape[1:], dtype=np.int64))
            buf = (ctypes.c_char * (count * c.dtype.itemsize)).from_address(ptr)
            arr = np.frombuffer(buf, dtype=c.dtype, count=count).reshape(shape)
            batch.append(arr.copy() if self._copy else arr)
        return tuple(batch)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.etpu_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def batch_iterator(columns, order, batch_size: int, copy: bool = True):
    """Shuffled batch iterator: native prefetching loader when built,
    pure-numpy gather otherwise. Yields tuples of per-column batches.

    ``copy=False`` skips the copy out of the loader's ring buffer: batches
    are then only valid until the next iteration (fine for a train loop
    that consumes each batch before advancing, wrong for ``list()``).
    """
    try:
        loader = NativeBatchLoader(columns, order, batch_size, copy=copy)
    except RuntimeError:  # library not built — use the Python gather
        loader = None
    if loader is not None:
        yield from loader
        return
    n = len(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        yield tuple(np.asarray(c)[idx] for c in columns)


def recv_frame_native(fd: int) -> Optional[memoryview]:
    lib = _load()
    if lib is None:
        return None
    length = lib.etpu_recv_frame_len(fd)
    if length < 0:
        raise ConnectionError("socket closed while reading frame")
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {length} exceeds limit")
    # uninitialized (no bytearray memset): etpu_recv_frame_body either
    # fills every byte or errors, and the error path never returns the
    # buffer — the shared alloc_frame ownership contract
    out = alloc_frame(int(length))
    buf = (ctypes.c_char * int(length)).from_buffer(out)
    if lib.etpu_recv_frame_body(fd, buf, length) != 0:
        raise ConnectionError("socket closed while reading frame body")
    del buf
    return out  # bytes-like; decode reads it in place without another copy
