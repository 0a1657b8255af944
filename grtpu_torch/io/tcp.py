"""TCP sample transport.

Port of ``grtpu.io.tcp`` (host only).

Analogs (SURVEY.md §2.8 grc): blks2.tcp_source / blks2.tcp_sink
(grc/grc_gnuradio/blks2/tcp.py:46-66): a TCP socket — client connect or
server accept — whose file descriptor feeds a file_descriptor_source/sink.
Here the stream layer is direct: exact-count reads with a byte residual
(TCP is a byte stream; item boundaries are reassembled), matching the
UdpSource/UdpSink surface so either transport feeds the executor loop.
"""

from __future__ import annotations

import socket
from typing import Iterator, Optional

import numpy as np


def _open_stream_sock(host: str, port: int, server: bool,
                      timeout: Optional[float]) -> socket.socket:
    """Client: block on connect.  Server: block on accept (one peer),
    mirroring blks2 tcp _get_sock_fd semantics."""
    if server:
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(1)
        if timeout is not None:
            lsock.settimeout(timeout)
        conn, _ = lsock.accept()
        lsock.close()
    else:
        conn = socket.create_connection((host, port), timeout=timeout)
    if timeout is not None:
        conn.settimeout(timeout)
    return conn


class TcpSource:
    """Receive a sample stream over TCP (blks2_tcp_source semantics:
    server=True accepts one connection; peer close is EOF)."""

    def __init__(self, host: str, port: int, dtype=np.complex64,
                 server: bool = True, timeout: Optional[float] = 5.0):
        self.dtype = np.dtype(dtype)
        self.sock = _open_stream_sock(host, port, server, timeout)
        self._residual = b""
        self._eof = False

    def read_items(self, n: int) -> Optional[np.ndarray]:
        """Blocking read of exactly n items (or None at EOF/timeout)."""
        need = n * self.dtype.itemsize
        buf = bytearray(self._residual)
        while len(buf) < need and not self._eof:
            try:
                pkt = self.sock.recv(65536)
            except socket.timeout:
                break
            if len(pkt) == 0:
                self._eof = True
                break
            buf.extend(pkt)
        if len(buf) < need:
            self._residual = bytes(buf)
            return None
        self._residual = bytes(buf[need:])
        return np.frombuffer(bytes(buf[:need]), self.dtype)

    def chunks(self, chunk_items: int) -> Iterator[np.ndarray]:
        while True:
            arr = self.read_items(chunk_items)
            if arr is None:
                return
            yield arr

    def close(self):
        self.sock.close()


class TcpSink:
    """Send a sample stream over TCP (blks2_tcp_sink semantics:
    client connect by default; sendall preserves the byte stream)."""

    def __init__(self, host: str, port: int, dtype=np.complex64,
                 server: bool = False, timeout: Optional[float] = 5.0):
        self.dtype = np.dtype(dtype)
        self.sock = _open_stream_sock(host, port, server, timeout)

    def write_items(self, data: np.ndarray):
        raw = np.ascontiguousarray(np.asarray(data, self.dtype)).tobytes()
        self.sock.sendall(raw)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        self.sock.close()
