"""Packet-mode modem framework: mod_pkts / demod_pkts.

Port of ``grtpu.digital.pkt``.  Analog of gr-digital/python/pkt.py:33-128:
``mod_pkts`` accepts payloads via ``send_pkt`` (a MsgQueue feeding the modulator), ``demod_pkts`` watches
the demodulated bit stream for access codes and posts CRC-checked payloads
to a callback through a queue-watcher thread.

Burst mode: samples accumulate per packet (the reference
streams continuously; here each send_pkt yields a sample burst, and the
receiver may be fed arbitrary sample streams incrementally)."""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from grtpu_torch.digital import packet
from grtpu_torch.runtime.msg import Message, MsgQueue, QueueWatcher


def _host(x) -> np.ndarray:
    """A modem's output (a tensor on its device, or numpy) on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ModPkts:
    """mod_pkts: payload messages -> modulated sample bursts."""

    def __init__(self, modem, access_code=None, pad_for_usrp: bool = False,
                 preamble_idle_bits: int = 64):
        self.modem = modem
        self.access_code = access_code
        self.idle = preamble_idle_bits
        self.msgq = MsgQueue()

    def send_pkt(self, payload: bytes = b"", eof: bool = False):
        """Queue a payload (pkt.py send_pkt); eof posts the EOF marker."""
        if eof:
            self.msgq.insert_tail(Message(kind=1))
        else:
            self.msgq.insert_tail(Message(payload=bytes(payload)))

    def samples(self) -> Optional[np.ndarray]:
        """Modulate the next queued payload; None when drained/EOF."""
        msg = self.msgq.delete_head_nowait()
        if msg is None or msg.kind == 1:
            return None
        bits = packet.make_packet(msg.to_string(), self.access_code)
        rng = np.random.RandomState(0)
        stream = np.concatenate([
            rng.randint(0, 2, self.idle).astype(np.uint8), bits,
            np.zeros(16, np.uint8)])
        return _host(self.modem.modulate(stream))

    def drain(self) -> List[np.ndarray]:
        out = []
        while True:
            s = self.samples()
            if s is None:
                break
            out.append(s)
        return out


class DemodPkts:
    """demod_pkts: sample stream -> demod -> access-code hunt -> CRC check
    -> callback(ok, payload) via a watcher thread."""

    def __init__(self, modem, callback: Callable[[bool, bytes], None],
                 access_code=None, threshold: int = 2):
        self.modem = modem
        self.access_code = access_code
        self.threshold = threshold
        self.msgq = MsgQueue()
        self._watcher = QueueWatcher(self.msgq, self._deliver)
        self._callback = callback
        self._bit_residual = np.zeros(0, np.uint8)

    def _deliver(self, msg: Message):
        ok = bool(msg.kind)
        self._callback(ok, msg.to_string())

    def process_samples(self, samples: np.ndarray):
        """Feed received samples; posts one message per found packet."""
        bits = _host(self.modem.demodulate(samples)).astype(np.uint8)
        bits = np.concatenate([self._bit_residual, bits])
        consumed = 0
        while True:
            idx = packet.find_access_code(bits[consumed:], self.access_code,
                                          self.threshold)
            if idx is None:
                break
            base = consumed + idx
            hdr_bits = bits[base: base + 32]
            if len(hdr_bits) < 32:
                break
            parsed = packet.parse_header(packet.bits_to_bytes(hdr_bits))
            if parsed is None:
                consumed = base
                continue
            plen, off = parsed
            body = bits[base + 32: base + 32 + plen * 8]
            if len(body) < plen * 8:
                break
            ok, payload = packet.unmake_packet(body, off)
            self.msgq.insert_tail(
                Message(payload=payload, kind=1 if ok else 0))
            consumed = base + 32 + plen * 8
        self._bit_residual = bits[consumed:][-4096:]

    def stop(self, timeout: float = 10.0):
        self._watcher.stop(timeout)
