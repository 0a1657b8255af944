"""XML-RPC runtime control surface.

Port of ``grtpu.io.xmlrpc_ctl`` (host only).

Analogs (SURVEY.md §2.8 grc): the xmlrpc_server / xmlrpc_client GRC blocks
(grc/blocks/xmlrpc_server.xml, xmlrpc_client.xml): GRC-generated scripts
start a SimpleXMLRPCServer registered on the top block, exposing start/
stop/wait plus every variable callback (``set_freq(...)`` etc.); the client
block is an xmlrpclib Server proxy whose callback fires on variable change.

Here the server wraps any object (typically a TopBlock or a GRC-loaded
flowgraph adapter); only public callables are exported, and variable
setters route through the TopBlock lock/unlock rebuild so a remote
``set_*`` takes effect on the running compiled graph.
"""

from __future__ import annotations

import threading
from typing import Optional
from xmlrpc.client import ServerProxy
from xmlrpc.server import SimpleXMLRPCServer


class XmlrpcServer:
    """Serve an object's public callables over XML-RPC in a daemon thread.

    ``XmlrpcServer(tb, 'localhost', 8080)`` matches the generated
    xmlrpc_server block: remote clients may call ``start``, ``stop``,
    ``wait``, and any ``set_<variable>`` the wrapped object defines.
    """

    def __init__(self, instance, addr: str = "localhost", port: int = 8080,
                 start: bool = True):
        self.server = SimpleXMLRPCServer((addr, port), allow_none=True,
                                         logRequests=False)
        self.server.register_instance(_PublicOnly(instance))
        self.server.register_introspection_functions()
        self.addr, self.port = self.server.server_address[:2]
        self.thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self):
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        if self.thread is not None:
            self.thread.join(timeout=5.0)


class _PublicOnly:
    """Dispatch wrapper: only public (non-underscore) callables resolve."""

    def __init__(self, instance):
        self._instance = instance

    def _dispatch(self, method, params):
        if method.startswith("_"):
            raise AttributeError(f"method {method!r} not exported")
        fn = getattr(self._instance, method, None)
        if not callable(fn):
            raise AttributeError(f"method {method!r} not exported")
        return fn(*params)

    def _listMethods(self):
        return sorted(m for m in dir(self._instance)
                      if not m.startswith("_")
                      and callable(getattr(self._instance, m)))


class XmlrpcClient:
    """xmlrpc_client block analog: proxy plus the GRC callback pattern —
    ``client.callback('set_freq', 5000)`` invokes the remote setter, and
    attribute access falls through to the proxy (``client.set_freq(5000)``).
    """

    def __init__(self, addr: str = "localhost", port: int = 8080):
        self.proxy = ServerProxy(f"http://{addr}:{port}", allow_none=True)

    def callback(self, name: str, *values):
        return getattr(self.proxy, name)(*values)

    def __getattr__(self, name):
        return getattr(self.proxy, name)
