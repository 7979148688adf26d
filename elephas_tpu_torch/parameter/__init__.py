"""The parameter plane of asynchronous training: one HTTP or raw-TCP
parameter server and its clients (copies of ``elephas_tpu/parameter``'s
``client.py``, ``server.py`` and ``factory.py``, less the paths that
serve the sharded plane, standbys and live-weight subscribers).
``sharding.py`` and ``replication.py`` are not ported (ROADMAP Queue 1
item 4)."""
from .client import BaseParameterClient, HttpClient, SocketClient
from .factory import (ClientServerFactory, HttpFactory, SocketFactory,
                      Transport, available_transports,
                      create_sharded_client, create_sharded_server,
                      get_transport, register_transport)
from .server import BaseParameterServer, HttpServer, SocketServer

__all__ = ["BaseParameterClient", "HttpClient", "SocketClient",
           "ClientServerFactory",
           "HttpFactory", "SocketFactory", "Transport",
           "available_transports", "create_sharded_client",
           "create_sharded_server", "get_transport", "register_transport",
           "BaseParameterServer", "HttpServer", "SocketServer"]
