"""The port's parameter plane against the JAX package's.

Pull and push through the port's HTTP and socket servers and clients in
``asynchronous`` (RWLock) and ``hogwild`` mode; the wire codec and the
int8 frame with error feedback; and the wire between the packages: a
JAX client pulls from and pushes to the port's server, a port client
the JAX server's, over both transports, and the same weights encode to
the same bytes in both packages. Ports come from the OS (bind to port
0), so these tests never collide with the JAX parameter tests' ranges.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from elephas_tpu.parameter import client as jclient
from elephas_tpu.parameter import server as jserver
from elephas_tpu.utils import delta_compression as jdc
from elephas_tpu.utils import tensor_codec as jcodec
from elephas_tpu_torch.parameter import (HttpClient, HttpServer, SocketClient,
                                         SocketServer, create_sharded_client,
                                         create_sharded_server)
from elephas_tpu_torch.utils import delta_compression as tdc
from elephas_tpu_torch.utils import native
from elephas_tpu_torch.utils import tensor_codec as tcodec
from elephas_tpu_torch.utils.sockets import free_port

PACKAGES = {"torch": ({"http": (HttpServer, HttpClient),
                       "socket": (SocketServer, SocketClient)}),
            "jax": ({"http": (jserver.HttpServer, jclient.HttpClient),
                     "socket": (jserver.SocketServer, jclient.SocketClient)})}


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((13, 7)).astype(np.float32),
            rng.standard_normal(7).astype(np.float32),
            rng.standard_normal((7, 3)).astype(np.float32)]


def _serve(package, transport, weights, mode="asynchronous"):
    server_cls, _ = PACKAGES[package][transport]
    server = server_cls({"model": "{}", "weights": weights}, free_port(), mode)
    server.start()
    return server


def _client(package, transport, port, **kw):
    return PACKAGES[package][transport][1](port, **kw)


@pytest.mark.parametrize("mode", ["asynchronous", "hogwild"])
@pytest.mark.parametrize("transport", ["http", "socket"])
def test_pull_and_push(transport, mode):
    w0 = _weights()
    server = _serve("torch", transport, w0, mode)
    client = _client("torch", transport, server.port)
    try:
        assert client.health_check()
        for got, want in zip(client.get_parameters(), w0):
            np.testing.assert_array_equal(got, want)
        delta = _weights(1)
        client.update_parameters(delta)
        client.update_parameters(delta)
        for got, w, d in zip(client.get_parameters(), w0, delta):
            np.testing.assert_array_equal(got, (w - d) - d)
        assert server.num_updates == 2
        # wrong arity: rejected (HTTP 400, or the socket's NACK)
        with pytest.raises((OSError, ValueError)):
            client.update_parameters(delta[:2])
        assert server.num_updates == 2
    finally:
        client.close()
        server.stop()


def test_codec_round_trip_and_bytes_match_jax():
    weights = _weights() + [np.arange(5, dtype=np.int32),
                            np.zeros((0, 4), np.float32)]
    payload = tcodec.encode_weights(weights)
    assert bytes(payload) == bytes(jcodec.encode_weights(weights))
    # the Python codec is the spec; the native one (when built) agrees
    assert bytes(tcodec.encode_tensors(weights, tcodec.KIND_WEIGHTS)) \
        == bytes(payload)
    for got, want in zip(tcodec.decode_weights(payload), weights):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    arrays, kind = tcodec.decode(jcodec.encode(weights, jcodec.KIND_DELTA))
    assert kind == tcodec.KIND_DELTA and len(arrays) == len(weights)
    assert isinstance(native.available(), bool)
    with pytest.raises(tcodec.CodecError):
        tcodec.decode(b"ETPU" + bytes(3))


def test_int8_frame_with_error_feedback():
    rng = np.random.default_rng(3)
    deltas = [[rng.standard_normal((13, 7)).astype(np.float32) * 1e-2,
               rng.standard_normal(7).astype(np.float32) * 1e-3]
              for _ in range(20)]
    frame = tdc.quantize_delta(deltas[0])
    assert [a.dtype for a in frame] == [np.int8, np.float32] * 2
    for a, b in zip(frame, jdc.quantize_delta(deltas[0])):
        np.testing.assert_array_equal(a, b)
    assert bytes(tcodec.encode(frame, tcodec.KIND_DELTA_Q8)) == bytes(
        jcodec.encode(frame, jcodec.KIND_DELTA_Q8))
    ef = tdc.ErrorFeedback()
    applied = [np.zeros_like(d) for d in deltas[0]]
    for delta in deltas:
        ef.apply(delta)
        on_wire = tdc.dequantize_delta(ef.last_frame)
        for a, b in zip(on_wire, ef.last_on_wire):
            np.testing.assert_array_equal(a, b)
        applied = [a + w for a, w in zip(applied, on_wire)]
    # what the server sums stays within one quantization step of the sum
    # of the raw deltas: the residual does not grow with the push count
    for i, total in enumerate(zip(*deltas)):
        raw = np.sum(total, axis=0)
        step = np.abs(raw).max() / 127 + np.abs(deltas[-1][i]).max() / 127
        assert np.abs(applied[i] - raw).max() <= 2 * step


@pytest.mark.parametrize("transport", ["http", "socket"])
def test_compressed_push_reaches_the_server_dequantized(transport):
    w0 = _weights()
    server = _serve("torch", transport, w0)
    client = create_sharded_client(transport, server.port, None, 1,
                                   compression="int8")
    try:
        delta = _weights(2)
        client.update_parameters(delta)
        want = [w - d for w, d in zip(
            w0, tdc.dequantize_delta(tdc.quantize_delta(delta)))]
        for got, w in zip(client.get_parameters(), want):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("transport", ["http", "socket"])
def test_wire_parity_across_packages(transport, server_pkg, client_pkg):
    w0 = _weights()
    server = _serve(server_pkg, transport, w0)
    client = _client(client_pkg, transport, server.port)
    q8 = _client(client_pkg, transport, server.port, compression="int8")
    try:
        assert client.health_check()
        pulled = client.get_parameters()
        for got, want in zip(pulled, w0):
            np.testing.assert_array_equal(got, want)
        # both servers serve the same bytes for the same weights
        assert bytes(server.encoded_weights()) == bytes(
            tcodec.encode_weights(w0))
        delta = _weights(1)
        client.update_parameters(delta)
        q8.update_parameters(delta)
        want = [w - d - dq for w, d, dq in zip(
            w0, delta, jdc.dequantize_delta(jdc.quantize_delta(delta)))]
        for got, w in zip(client.get_parameters(), want):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)
        assert server.num_updates == 2
    finally:
        client.close()
        q8.close()
        server.stop()


def test_sharded_plane_and_standby_raise():
    model = {"model": "{}", "weights": _weights()}
    for kw in ({"num_shards": 2}, {"num_shards": 1, "standby": True}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            create_sharded_server("http", model, free_port(), "asynchronous",
                                  **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        create_sharded_client("socket", free_port(), model, 2)


@pytest.mark.parametrize("transport", ["http", "socket"])
def test_port_server_rejects_the_sharded_plane_calls(transport):
    """The port copies only the single-server plane: the JAX client's
    two-phase, replication, generation and version calls are refused by
    the port's server (HTTP 404, which the JAX client reads on
    ``/commit`` as an unknown transaction; the socket drops the
    connection), and an ordinary pull on the same client still works
    afterwards."""
    w0 = _weights()
    server = _serve("torch", transport, w0)
    client = _client("jax", transport, server.port, max_retries=0,
                     timeout=5.0)
    delta = [np.ones_like(w) for w in w0]
    calls = [lambda: client.prepare_frame(delta, jcodec.KIND_DELTA, "t" * 32),
             lambda: client.commit_txn("t" * 32),
             lambda: client.replicate_frame(delta, jcodec.KIND_DELTA,
                                            "u" * 32, 1),
             client.get_generation, client.get_version]
    try:
        for call in calls:
            with pytest.raises((OSError, jclient.UnknownTxnError)):
                call()
        for got, want in zip(client.get_parameters(), w0):
            np.testing.assert_array_equal(got, want)
        assert server.num_updates == 0
    finally:
        client.close()
        server.stop()
