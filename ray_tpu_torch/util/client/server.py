"""Client proxy server: TCP ⇄ cluster-local unix sockets.

See package docstring.  Wire format: the first message on a new TCP
connection is ``{"target": "gcs" | "<unix socket path>"}``; afterwards the
proxy pumps pickled messages both ways until either side disconnects.
Actor targets are validated against the session socket dir so a client
cannot use the proxy to reach arbitrary local sockets.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private import protocol, rtlog

logger = rtlog.get("client-proxy")


class ClientProxyServer:
    """Binds loopback by default; exposing it beyond localhost requires an
    explicit host AND sharing the session auth key (RTT_AUTH_KEY on the
    client) — the connection handshake HMACs against the per-session
    secret, never the module default."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 10001):
        self.session = session
        self.host = host
        self.port = port
        self._listener = protocol.make_tcp_listener(host, port)
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="client-proxy", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        protocol.serve_accept_loop(self._listener, self._stopped.is_set,
                                   self._serve, "client-proxy-serve")

    def _resolve_target(self, target: str) -> Optional[str]:
        import os
        if target == "gcs":
            return self.session.socket_path("gcs.sock")
        # tcp://host:port: dial-out relay to an actor on a remote-agent
        # host (hub-spoke: clients that can't reach sibling hosts route
        # through the head).  The handshake already HMAC-authenticated the
        # caller against the session secret — an authed principal can run
        # arbitrary tasks anyway, so relaying adds no privilege.
        if protocol.parse_tcp_addr(target) is not None:
            return target
        # actor sockets live in the session socket dir; refuse anything
        # else — realpath first so ../ traversal cannot escape it
        path = os.path.realpath(str(target))
        sock_dir = os.path.realpath(str(self.session.socket_dir))
        if os.path.dirname(path) == sock_dir:
            return path
        return None

    def _serve(self, client_conn) -> None:
        try:
            hello = client_conn.recv()
            path = self._resolve_target(hello.get("target", ""))
            if path is None:
                client_conn.send({"error": "invalid target"})
                client_conn.close()
                return
            upstream = protocol.connect_addr(path)
            client_conn.send({"ok": True})
        except (EOFError, OSError, FileNotFoundError) as e:
            try:
                client_conn.send({"error": str(e)})
            except (OSError, ValueError):
                pass
            client_conn.close()
            return

        # Teardown protocol for the conn pair.  The FIRST pump to exit
        # only shutdown()s both sockets: that interrupts the sibling's
        # blocked recv() AND sends FIN to both far ends (a bare close()
        # would do neither while a read is in flight — the kernel socket
        # stays alive and death detection upstream never fires).  The
        # SECOND pump then close()s the fds — only once no thread can
        # touch them again, so a recycled fd number can never belong to
        # some unrelated new connection when we act on it.
        lock = threading.Lock()
        state = {"finished": False}

        def pump(src, dst):
            # opaque byte-frame relay: never decode — versioned wire
            # frames (_private/wire.py) and legacy pickle pass through
            # identically, and the proxy skips a pickle round-trip
            while True:
                try:
                    dst.send_bytes(src.recv_bytes())
                except (EOFError, OSError, ValueError):
                    break
            with lock:
                first = not state["finished"]
                state["finished"] = True
            if first:
                protocol.shutdown_conn(src)
                protocol.shutdown_conn(dst)
            else:
                for c in (src, dst):
                    try:
                        c.close()
                    except OSError:
                        pass

        t = threading.Thread(target=pump, args=(client_conn, upstream),
                             daemon=True, name="client-proxy-pump")
        t.start()
        pump(upstream, client_conn)

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
