"""UDP sample transport — the reference's only inter-host stream transport.

Port of ``grtpu.io.udp`` (host numpy arrays in and out).

Analogs (SURVEY.md §2.6/§5.8): gr_udp_source / gr_udp_sink
(gnuradio-core/src/lib/io/gr_udp_source.h:39-99, gr_udp_sink.h:39-86):
raw-datagram sample streaming, default payload 1472 bytes, zero-length
datagram as EOF, optional blocking wait.

Role here: host-side ingest/egress feeding the executor's chunk loop
(``StreamExecutor.stream()``), for interop with external sample sources.
"""

from __future__ import annotations

import socket
from typing import Iterator, Optional

import numpy as np


class UdpSource:
    """Receive a sample stream over UDP datagrams.

    Iterate :meth:`chunks` to get fixed-size arrays for the executor.
    """

    def __init__(self, host: str, port: int, dtype=np.complex64,
                 payload_size: int = 1472, eof_on_zero: bool = True,
                 timeout: Optional[float] = 1.0):
        self.dtype = np.dtype(dtype)
        self.payload_size = payload_size - payload_size % self.dtype.itemsize
        self.eof_on_zero = eof_on_zero
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        if timeout is not None:
            self.sock.settimeout(timeout)
        self._residual = b""
        self._eof = False

    def read_items(self, n: int) -> Optional[np.ndarray]:
        """Blocking read of exactly n items (or None at EOF)."""
        need = n * self.dtype.itemsize
        buf = bytearray(self._residual)
        while len(buf) < need and not self._eof:
            try:
                pkt = self.sock.recv(self.payload_size)
            except socket.timeout:
                break
            if len(pkt) == 0 and self.eof_on_zero:
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


class UdpSink:
    """Send a sample stream over UDP datagrams (gr_udp_sink semantics;
    send_eof sends a zero-length datagram)."""

    def __init__(self, host: str, port: int, dtype=np.complex64,
                 payload_size: int = 1472, send_eof: bool = True):
        self.dtype = np.dtype(dtype)
        self.payload_size = payload_size - payload_size % self.dtype.itemsize
        self.addr = (host, port)
        self.send_eof = send_eof
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def write_items(self, data: np.ndarray):
        raw = np.ascontiguousarray(np.asarray(data, self.dtype)).tobytes()
        for off in range(0, len(raw), self.payload_size):
            self.sock.sendto(raw[off:off + self.payload_size], self.addr)

    def close(self):
        if self.send_eof:
            try:
                self.sock.sendto(b"", self.addr)
            except OSError:
                pass
        self.sock.close()


def native_udp_source(host: str, port: int, dtype=np.complex64,
                      payload_size: int = 1472, ring_bytes: int = 1 << 22):
    """UdpSource on the native data plane: a C++ receiver thread fills a
    double-mapped ring (grtpu_torch.io.native.UdpPump) so datagram handling never
    runs in the Python chunk loop.  Returns an object with the same
    read_items/chunks/close surface as :class:`UdpSource`."""
    from grtpu_torch.io import native

    class _NativeUdpSource:
        def __init__(self):
            self.dtype = np.dtype(dtype)
            self.ring = native.RingBuffer(ring_bytes)
            self.pump = native.UdpPump(self.ring, host, port, payload_size)

        def read_items(self, n: int, timeout: float = 5.0):
            import time as _time
            deadline = _time.monotonic() + timeout
            need = n * self.dtype.itemsize
            while (self.ring.readable < need and not self.ring.eof
                   and _time.monotonic() < deadline):
                _time.sleep(0.0002)
            if self.ring.readable < need:
                return None
            return self.ring.read_items(n, self.dtype)

        def chunks(self, chunk_items: int):
            while True:
                arr = self.read_items(chunk_items)
                if arr is None:
                    return
                yield arr

        def stats(self):
            """(datagrams landed, bytes landed, kernel socket drops)."""
            return (self.pump.rx_dgrams, self.pump.rx_bytes,
                    self.pump.drops)

        def close(self):
            self.pump.stop()
            self.ring.close()

    return _NativeUdpSource()
