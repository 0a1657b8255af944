"""Streaming packet encoder/decoder graph blocks.

Port of ``grtpu.digital.packet_blocks``.  Analogs: grc_gnuradio/blks2/
packet.py packet_mod_X / packet_demod_X (the blks2_packet_encoder /
blks2_packet_decoder GRC blocks): the encoder slices the raw item bytes of
a stream into fixed-size payloads and wraps each in the packet_utils
framing (preamble + access code + 2x16-bit header + whitened payload+CRC32
+ trailer); the decoder hunts access codes in the demodulated bit stream,
checks the CRC, and re-emits the recovered payload bytes as the original
item stream.

Both directions are in-graph.  Encoding is fixed-rate (payload_length in ->
one packet's bytes out); CRC32 is grtpu's byte scan over the table, one
step a byte (a Python loop of table gathers, vectorized over the packets of
a chunk: a 256-byte payload is 256 steps of about six device operations
each), and whitening a static XOR mask.  Decoding is a variable-rate block:
per chunk it locates up to ``maxp`` access codes (one FIR correlation and a
static-size selection), validates headers and CRCs of all candidates at
once, takes them in order with a loop of static count (a candidate inside
an already accepted packet is skipped, as grtpu's scan does), and compacts
the good payloads into a valid prefix with one scatter — no host read, so
a chunk captures into one CUDA graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from grtpu_torch.digital import packet as pu
from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.utils.device import constant

_DT = {"complex": torch.complex64, "float": torch.float32, "int": torch.int32,
       "short": torch.int16, "byte": torch.uint8}
_ITEMSIZE = {"complex": 8, "float": 4, "int": 4, "short": 2, "byte": 1}


@functools.lru_cache(maxsize=8)
def _crc_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pu._TABLE.astype(np.int64)).to(device)


def _crc32_scan(by: torch.Tensor) -> torch.Tensor:
    """digital_crc32 over the last axis of a (..., L) uint8 tensor (int64
    result in [0, 2^32)): a table lookup per byte, like the reference's
    update_crc32 loop."""
    table = _crc_table(by.device)
    b = by.to(torch.int64)
    crc = torch.full(by.shape[:-1], 0xFFFFFFFF, dtype=torch.int64,
                     device=by.device)
    for i in range(by.shape[-1]):
        idx = ((crc >> 24) ^ b[..., i]) & 0xFF
        crc = ((crc << 8) & 0xFFFFFFFF) ^ table[idx]
    return crc ^ 0xFFFFFFFF


def _bytes_to_bits(by: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes -> (..., 8n) bits, MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=by.device)
    return ((by[..., None] >> shifts) & 1).reshape(by.shape[:-1] + (-1,))


def _bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n) bits -> (..., n) bytes, MSB first."""
    b = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.int32)
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def _items_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Raw little-endian item bytes (the reference payload is
    msg.to_string() of the stream slice); a complex64 item is its real and
    imaginary float32, 8 bytes."""
    if x.dtype == torch.uint8:
        return x
    if x.dtype == torch.complex64:
        x = torch.view_as_real(x)
    return x.contiguous().view(torch.uint8).reshape(-1)


def _bytes_to_items(by: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`_items_to_bytes` over the last axis of a (..., n)
    byte tensor."""
    if dtype == torch.uint8:
        return by
    lead = by.shape[:-1]
    if dtype == torch.complex64:
        f = by.contiguous().view(torch.float32)
        return torch.view_as_complex(f.reshape(lead + (-1, 2)))
    return by.contiguous().view(dtype)


def _code(access_code) -> np.ndarray:
    return (np.asarray(access_code, np.uint8) if access_code is not None
            and len(np.atleast_1d(access_code))
            else pu.DEFAULT_ACCESS_CODE_BITS)


class PacketEncoder(Block):
    """blks2_packet_encoder: item stream -> framed packet bytes.

    Fixed rate: every ``payload_length`` input bytes becomes one packet of
    bytes(preamble+access+header+whitened(payload+crc)+trailer).  The
    output feeds a byte-consuming modulator (GenericModBlock, GmskModBlock
    — the dpsk_loopback.grc chain)."""

    def __init__(self, type: str = "float", payload_length: int = 256,
                 access_code=None, samples_per_symbol: int = 2,
                 bits_per_symbol: int = 1, pad_for_usrp: bool = False,
                 name=None):
        dt = _DT[type]
        if payload_length in (0, None):
            payload_length = 256
        itemsize = _ITEMSIZE[type]
        if payload_length % itemsize:
            raise ValueError("payload_length must be a multiple of the "
                             "stream itemsize")
        self.in_ports = (Port(dt),)
        self.out_ports = (Port(torch.uint8),)
        ref_bits = pu.make_packet(b"\x00" * payload_length,
                                  access_code if access_code else None)
        assert len(ref_bits) % 8 == 0
        self.decim = payload_length // itemsize
        self.interp = len(ref_bits) // 8
        super().__init__(name)
        self.payload_length = payload_length
        code = _code(access_code)
        hdr = pu.make_header(payload_length + 4)
        self._head_bits = np.concatenate(
            [pu.DEFAULT_PREAMBLE_BITS, code,
             np.unpackbits(np.frombuffer(hdr, np.uint8))]).astype(np.uint8)
        self._trailer_bits = np.unpackbits(
            np.frombuffer(b"\x55", np.uint8)).astype(np.uint8)
        self._wh = pu._WHITENER[: payload_length + 4].copy()
        self._dtype = dt

    def apply(self, state, x):
        dev = x.device
        by = _items_to_bytes(x).reshape(-1, self.payload_length)
        nb = by.shape[0]
        crc = _crc32_scan(by)
        crcb = torch.stack([(crc >> s) & 0xFF for s in (24, 16, 8, 0)],
                           dim=-1).to(torch.uint8)
        body = torch.cat([by, crcb], dim=1) ^ constant(self, "_wh", dev)
        bits = torch.cat([
            constant(self, "_head_bits", dev).expand(nb, -1),
            _bytes_to_bits(body),
            constant(self, "_trailer_bits", dev).expand(nb, -1)], dim=1)
        return state, _bits_to_bytes(bits).reshape(-1)


class PacketDecoder(Block):
    """blks2_packet_decoder: demodulated BIT stream (one bit per byte, the
    GenericDemodBlock/GmskDemodBlock output) -> recovered item stream.

    Variable rate: locates access codes with one correlation, validates
    header + CRC32 per candidate, and emits only the good payloads
    (compacted in-chunk to a valid prefix).  The reference's message-queue
    + watcher-thread plumbing (packet.py _packet_decoder_thread) collapses
    into the step."""

    variable_rate = True

    def __init__(self, type: str = "float", payload_length: int = 256,
                 access_code=None, threshold: int = -1, name=None):
        dt = _DT[type]
        if payload_length in (0, None):
            payload_length = 256
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(dt),)
        self.code = _code(access_code)
        self.threshold = 0 if threshold in (None, -1) else int(threshold)
        self.payload_length = payload_length
        self.body_bits = (payload_length + 4) * 8
        # header(32) + body + trailer slack after the access code
        self.tail_bits = 32 + self.body_bits
        self.history = len(self.code) + self.tail_bits + 1
        super().__init__(name)
        self._wh = pu._WHITENER[: payload_length + 4].copy()
        self._dtype = dt
        self._itemsize = _ITEMSIZE[type]

    @property
    def nominal_rate(self):
        # payload items out per input bit: L/itemsize per packet of
        # ~(128 + tail) bits
        per_pkt = self.payload_length // self._itemsize
        return per_pkt / float(len(self.code) + 32 + self.tail_bits)

    def max_out_for(self, n_delivered: int) -> int:
        per_pkt = self.payload_length // self._itemsize
        maxp = n_delivered // self.tail_bits + 1
        return maxp * per_pkt

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)  # absolute bit index of chunk start

    def apply(self, state, x):
        from grtpu_torch.digital.correlate import _first_true, access_code_detect

        dev = x.device
        n = x.shape[0]
        chunk_len = n - (self.history - 1)
        L = len(self.code)
        tail = self.tail_bits
        per_pkt = self.payload_length // self._itemsize
        maxp = n // tail + 1
        # flags[i] == 1 iff the code ends at delivered index i + L - 1
        flags = access_code_detect(x & 1, self.code, self.threshold)
        ends = torch.arange(flags.shape[0], device=dev) + (L - 1)
        # a packet is usable only if fully inside the delivered chunk; a
        # hit already consumed in the previous chunk (its whole tail fit
        # before the history boundary) is skipped, while a hit that was
        # DEFERRED there (tail ran past the chunk) re-appears via the
        # history and is taken now
        ok_pos = ((flags > 0) & (ends + 1 + tail <= n)
                  & (ends + 1 + tail > self.history - 1))
        hits = _first_true(ok_pos, maxp, n) + (L - 1)

        # every candidate's header, body and CRC at once; a start out of
        # range is clamped into the chunk, as JAX clamps a dynamic slice
        in_range = hits < n
        start = torch.clamp(hits + 1, 0, n - tail)
        pkt = x[start[:, None] + torch.arange(tail, device=dev)] & 1
        hdr = _bits_to_bytes(pkt[:, :32]).to(torch.int32)
        v1 = (hdr[:, 0] << 8) | hdr[:, 1]
        v2 = (hdr[:, 2] << 8) | hdr[:, 3]
        hdr_ok = (v1 == v2) & ((v1 & 0x0FFF) == self.payload_length + 4)
        body = _bits_to_bytes(pkt[:, 32:32 + self.body_bits]) ^ constant(
            self, "_wh", dev)
        crc = _crc32_scan(body[:, :-4])
        tail4 = body[:, -4:].to(torch.int64)
        want = (tail4[:, 0] << 24) | (tail4[:, 1] << 16) | \
            (tail4[:, 2] << 8) | tail4[:, 3]
        cand = in_range & hdr_ok & (crc == want)

        # in order: skip hits inside a consumed packet
        count = torch.zeros((), dtype=torch.int32, device=dev)
        last_end = torch.full((), -1, dtype=torch.int64, device=dev)
        goods, rows = [], []
        for j in range(maxp):
            good = cand[j] & (start[j] > last_end)
            rows.append(count)
            goods.append(good)
            count = count + good.to(torch.int32)
            last_end = torch.where(good, start[j] + tail - 1, last_end)
        good = torch.stack(goods)
        row = torch.where(good, torch.stack(rows).to(torch.int64), maxp)
        items = _bytes_to_items(body[:, :-4], self._dtype)
        out = torch.zeros((maxp + 1, per_pkt), dtype=self._dtype, device=dev)
        out = out.index_copy(0, row, items)   # rejected rows go to row maxp
        return state + chunk_len, (out[:maxp].reshape(-1), count * per_pkt)
