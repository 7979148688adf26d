"""Transport registry: matched parameter client/server construction.

Async/hogwild training needs a client and server speaking the same
transport (capability parity with ``elephas/parameter/factory.py:6-42``,
which dispatches via an abstract-factory subclass scan). Here a transport
is a plain registry entry — registering a new one is one call, and the
registry itself is the single source of truth for what transports exist.

Copied into the port from ``elephas_tpu/parameter/factory.py``
(host-only: no JAX); its relative imports resolve to the port's own
copies. The sharded plane (``num_shards > 1``) and hot standbys are
not ported: :func:`create_sharded_server` and
:func:`create_sharded_client` raise ``NotImplementedError`` for them.
"""
from typing import Dict, NamedTuple, Type

from .client import BaseParameterClient, HttpClient, SocketClient
from .server import BaseParameterServer, HttpServer, SocketServer


class Transport(NamedTuple):
    """A matched (client, server) pair for one wire protocol."""

    client_cls: Type[BaseParameterClient]
    server_cls: Type[BaseParameterServer]

    def create_client(self, *args, **kwargs) -> BaseParameterClient:
        return self.client_cls(*args, **kwargs)

    def create_server(self, *args, **kwargs) -> BaseParameterServer:
        return self.server_cls(*args, **kwargs)


_TRANSPORTS: Dict[str, Transport] = {}


def register_transport(name: str, client_cls: Type[BaseParameterClient],
                       server_cls: Type[BaseParameterServer]) -> None:
    """Register (or replace) a named transport."""
    _TRANSPORTS[name] = Transport(client_cls, server_cls)


def get_transport(name: str) -> Transport:
    """Look up a registered transport by name (e.g. ``'http'``)."""
    try:
        return _TRANSPORTS[name]
    except KeyError:
        raise ValueError(
            f"Unknown transport {name!r}; registered: "
            f"{sorted(_TRANSPORTS)}") from None


def available_transports():
    """Names of all registered transports."""
    return sorted(_TRANSPORTS)


register_transport("http", HttpClient, HttpServer)
register_transport("socket", SocketClient, SocketServer)


def _sharding_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 4, its remainder: "
        "the sharded parameter plane, hot standbys and the multi-host "
        "hooks); the port runs one parameter server")


def create_sharded_server(name: str, model, port: int, mode: str,
                          num_shards: int, standby: bool = False,
                          **kwargs):
    """A parameter plane of transport ``name`` on ``port``.

    ``num_shards=1`` returns an ordinary single server, as in the JAX
    package. A sharded plane (``num_shards > 1``) and ``standby`` are
    not ported and raise ``NotImplementedError``.
    """
    if int(num_shards) > 1:
        raise _sharding_not_ported(f"num_shards={num_shards}")
    if standby:
        raise _sharding_not_ported("standby=True")
    return get_transport(name).create_server(model, port, mode, **kwargs)


def create_sharded_client(name: str, port: int, model, num_shards: int,
                          compression=None, two_phase: bool = True,
                          **kwargs):
    """The matching client: a plain transport client for one shard, as
    in the JAX package. ``num_shards > 1`` raises
    ``NotImplementedError`` (``two_phase`` only matters there)."""
    if int(num_shards) > 1:
        raise _sharding_not_ported(f"num_shards={num_shards}")
    return get_transport(name).create_client(port, compression=compression,
                                             **kwargs)


class ClientServerFactory:
    """Back-compat shim over the registry: ``get_factory(name)`` returns the
    :class:`Transport`, which has the same ``create_client``/``create_server``
    surface the old factory objects exposed.

    New transports are added with :func:`register_transport` (the single
    extension point) — there is no subclass auto-registration.
    """

    @staticmethod
    def get_factory(name: str) -> Transport:
        return get_transport(name)


class HttpFactory(ClientServerFactory):
    """Back-compat alias for ``get_transport('http')``."""

    def create_client(self, *args, **kwargs):
        return get_transport("http").create_client(*args, **kwargs)

    def create_server(self, *args, **kwargs):
        return get_transport("http").create_server(*args, **kwargs)


class SocketFactory(ClientServerFactory):
    """Back-compat alias for ``get_transport('socket')``."""

    def create_client(self, *args, **kwargs):
        return get_transport("socket").create_client(*args, **kwargs)

    def create_server(self, *args, **kwargs):
        return get_transport("socket").create_server(*args, **kwargs)
