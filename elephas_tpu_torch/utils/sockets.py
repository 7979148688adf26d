"""Socket helpers and framed transport for the parameter-server layer.

Address discovery mirrors the reference (``elephas/utils/sockets.py:6-21``):
workers locate the parameter server via an environment variable or, absent
that, the host's own address (valid because in single-controller JAX the
coordinator process lives on host 0). ``ELEPHAS_TPU_MASTER_IP`` is the native
variable; ``SPARK_LOCAL_IP`` is honored for drop-in compatibility.

The wire frame replaces the reference's 20-byte ASCII length + pickle
(``elephas/utils/sockets.py:45-71``) with an 8-byte little-endian length
prefix followed by an ETPU typed-tensor payload (:mod:`.tensor_codec`) — no
arbitrary code execution on receive, and a format a C++ peer can speak.

Trace-context frame extension: a client carrying an active
:class:`~elephas_tpu.obs.context.TraceContext` prefixes an RPC with the
opcode ``b'T'`` plus the fixed-length (55-byte) W3C ``traceparent``
string; the parameter server applies it to the ONE RPC that follows.
Backward compatible by construction — old clients never send ``b'T'``
and the server's opcode loop is unchanged for them; the payload length
is fixed, so even a malformed traceparent leaves the stream in sync.

Copied into the port from ``elephas_tpu/utils/sockets.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies. The JAX module's two-phase-commit, replication, generation and
KV-transfer opcodes are left out: they serve the sharded plane, standbys
and disaggregated serving, which the port does not have yet. Added here:
:func:`free_port`, which the port's profiler, smoke script and tests use
to run a server where nothing else listens.
"""
import os
import socket
from socket import gethostbyname, gethostname
from typing import List, Optional, Sequence

import numpy as np

from ..obs.context import TRACEPARENT_LEN, TraceContext, parse_traceparent
from .faults import InjectedPartition, fault_network
from .tensor_codec import (KIND_WEIGHTS, MAX_FRAME_BYTES, alloc_frame,
                           decode, encode)

LENGTH_BYTES = 8

#: opcode introducing a traceparent frame on the PS socket protocol
TRACE_OPCODE = b"T"


def free_port() -> int:
    """A TCP port the OS has free now on the loopback (bound to port 0,
    read, closed)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def determine_master(port: int = 4000) -> str:
    """Determine ``host:port`` of the master/parameter server.

    Resolution order: ``$ELEPHAS_TPU_MASTER_IP``, ``$SPARK_LOCAL_IP`` (for
    compatibility with reference deployments), then this host's address.
    """
    host = os.environ.get("ELEPHAS_TPU_MASTER_IP") or os.environ.get("SPARK_LOCAL_IP")
    if not host:
        try:
            host = gethostbyname(gethostname())
        except socket.gaierror:
            host = "127.0.0.1"
    return host + ":" + str(port)


def _peer_of(sock: socket.socket) -> str:
    """``host:port`` of the connected peer, for (site, peer)-keyed
    network chaos; evaluated lazily (only when a fault plan is live)."""
    try:
        name = sock.getpeername()
        return f"{name[0]}:{name[1]}" if len(name) >= 2 else str(name)
    except OSError:
        return "?"


def recv_exact(sock: socket.socket, num_bytes: int) -> memoryview:
    """Read exactly ``num_bytes`` via ``recv_into`` a single preallocated
    buffer — one allocation per message, no chunk-list join, and no
    ``bytearray`` zero-fill of bytes the loop below is about to
    overwrite anyway (:func:`~.tensor_codec.alloc_frame`).

    Raises :class:`ConnectionError` when the peer closes mid-read: a
    half-closed socket returns ``b""`` from ``recv``, and fixed-length
    protocol reads (1-byte acks, 32-byte update ids, frame bodies) must
    never misread that as payload — which is also what upholds the
    uninitialized-buffer contract: the buffer is returned only once
    every byte has been received. All fixed-length reads in the
    parameter plane route through here."""
    if fault_network("net.recv", peer=lambda: _peer_of(sock), sock=sock):
        # a dropped inbound frame IS a timeout from the reader's side
        raise InjectedPartition("injected drop at site 'net.recv'")
    view = alloc_frame(num_bytes)
    got = 0
    while got < num_bytes:
        n = sock.recv_into(view[got:])
        if n == 0:
            raise ConnectionError(
                "socket closed while reading frame")
        got += n
    return view


# back-compat alias (the historical chunk-list reader's name)
_receive_all = recv_exact



def _use_native(sock: socket.socket) -> bool:
    """Native framing only on blocking sockets (Python timeouts put the fd
    in non-blocking mode, which the native loops do not handle)."""
    if sock.gettimeout() is not None:
        return False
    from . import native

    return native.available()


def send(sock: socket.socket, arrays: Sequence[np.ndarray], kind: int = KIND_WEIGHTS):
    """Send a list of arrays as one length-prefixed ETPU frame.

    Uses the native C++ codec + single-syscall-loop framing when built and
    the socket is in blocking mode.
    """
    payload = encode(arrays, kind)
    send_payload(sock, payload)


def send_payload(sock: socket.socket, payload) -> None:
    """Send one ALREADY-ENCODED ETPU payload as a length-prefixed frame
    (the cached-snapshot fast path: zero encode work, one or two
    ``sendall`` syscalls). ``payload`` may be ``bytes`` or the writable
    ``memoryview`` the zero-copy encoder returns."""
    if fault_network("net.send", peer=lambda: _peer_of(sock), sock=sock):
        return  # dropped: the bytes vanish, the peer blocks on its read
    if _use_native(sock):
        from . import native

        native.send_frame_native(sock.fileno(), payload)
        return
    sock.sendall(len(payload).to_bytes(LENGTH_BYTES, "little"))
    sock.sendall(payload)


def receive_frame(sock: socket.socket, copy: bool = True):
    """Receive one length-prefixed ETPU frame; returns ``(arrays, kind)``.

    The frame body lands in ONE preallocated buffer via
    ``recv_into`` (no chunk-list accumulation, no zero-fill). ``copy=False`` decodes
    zero-copy views of that buffer — the arrays alias the receive buffer
    and keep it alive; treat them as frozen snapshots.

    The transport is chosen up front (native or Python) and errors
    propagate: once any bytes of a frame are consumed, falling back to the
    other implementation would desync the stream.
    """
    if _use_native(sock):
        from . import native

        return decode(native.recv_frame_native(sock.fileno()), copy=copy)
    length = int.from_bytes(recv_exact(sock, LENGTH_BYTES), "little")
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {length} exceeds limit")
    return decode(recv_exact(sock, length), copy=copy)


def receive(sock: socket.socket, copy: bool = True) -> List[np.ndarray]:
    """Receive one ETPU frame; returns just the array list."""
    return receive_frame(sock, copy=copy)[0]



def send_trace_context(sock: socket.socket, ctx: TraceContext) -> None:
    """Send the trace-context frame extension (``b'T'`` + 55-byte
    traceparent) ahead of an RPC's opcode."""
    sock.sendall(TRACE_OPCODE + ctx.to_traceparent().encode("ascii"))


def receive_traceparent(sock: socket.socket) -> Optional[TraceContext]:
    """Read a ``b'T'`` frame's fixed-length payload (the opcode byte is
    already consumed); None for a malformed traceparent — the fixed
    length keeps the stream in sync either way."""
    raw = _receive_all(sock, TRACEPARENT_LEN)
    return parse_traceparent(bytes(raw).decode("ascii", "replace"))
