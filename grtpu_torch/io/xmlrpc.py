"""XML-RPC remote-control services (gnuradio-examples/grc/xmlrpc).

Port of ``grtpu.io.xmlrpc`` (host only).

Analogs: the GRC ``xmlrpc_server`` / ``xmlrpc_client`` blocks.  The
reference's generated script registers the top_block instance on a
SimpleXMLRPCServer so its variable setters (set_freq, set_ampl, ...) are
remotely callable (grc/python/Generator.py renders them from the
variable blocks); clients are ServerProxy stubs whose callbacks fire when
a GUI control changes.

grtpu mapping: flowgraph variables live in the loaded .grc environment
(grcxml.build_env).  The server exposes get_<var>/set_<var> for every
scalar env entry; a set updates the env and fires ``on_set`` so the
owner can rebuild the executor (the lock()/unlock() reconfiguration
path).  The client evaluates its variable expression in the local env
and pushes it to the remote callback via ``push()``.

These are *services*, not stream blocks: the GRC loader instantiates
them from the flowgraph and calls ``attach()``; they join ``byid`` but
never the stream graph.

Related: :mod:`grtpu_torch.io.xmlrpc_ctl` serves a TopBlock-like INSTANCE's
public callables (start/stop/set_*) — the surface GRC-generated python
scripts expose.  This module serves a LOADED .grc flowgraph's variable
environment — what the unmodified xmlrpc_{server,client}.grc files need.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional


class XmlRpcServerService:
    """GRC ``xmlrpc_server``: serve the flowgraph's variables over
    XML-RPC.  Binds (addr, port); if the configured port is taken an
    ephemeral port is chosen — read ``self.port`` after attach."""

    is_service = True

    def __init__(self, addr: str = "localhost", port: int = 1234):
        self.addr, self.port = addr, int(port)
        self.env: Optional[Dict[str, Any]] = None
        self.server = None
        self.thread: Optional[threading.Thread] = None
        self.on_set: Optional[Callable[[str, Any], None]] = None

    def attach(self, env: Dict[str, Any], byid, graph) -> None:
        from xmlrpc.server import SimpleXMLRPCServer

        self.env = env
        try:
            srv = SimpleXMLRPCServer((self.addr, self.port),
                                     allow_none=True, logRequests=False)
        except OSError:
            srv = SimpleXMLRPCServer((self.addr, 0), allow_none=True,
                                     logRequests=False)
        self.port = srv.server_address[1]

        def make_set(name):
            def f(v):
                env[name] = v
                if self.on_set is not None:
                    self.on_set(name, v)
                return True
            return f

        for k, v in list(env.items()):
            if isinstance(v, (bool, int, float, str)):
                srv.register_function(make_set(k), "set_" + k)
                srv.register_function((lambda name=k: env[name]), "get_" + k)
        self.server = srv
        self.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None


class XmlRpcClientService:
    """GRC ``xmlrpc_client``: a ServerProxy stub bound to one remote
    callback and one local variable expression; ``push()`` evaluates the
    expression in the flowgraph env and invokes the remote setter (the
    GUI-control-changed event of the reference)."""

    is_service = True

    def __init__(self, addr: str = "localhost", port: int = 1234,
                 callback: str = "", variable: str = ""):
        self.addr, self.rpc_port = addr, int(port)
        self.callback, self.variable = callback, variable
        self.env: Optional[Dict[str, Any]] = None
        self.proxy = None

    def attach(self, env: Dict[str, Any], byid, graph) -> None:
        import xmlrpc.client

        self.env = env
        self.proxy = xmlrpc.client.ServerProxy(
            f"http://{self.addr}:{self.rpc_port}", allow_none=True)

    def push(self):
        """Evaluate the bound expression and call the remote callback."""
        from grtpu_torch.grc.grcxml import _ev

        val = _ev(self.variable, self.env)
        if hasattr(val, "item"):
            val = val.item()
        return getattr(self.proxy, self.callback)(val)
