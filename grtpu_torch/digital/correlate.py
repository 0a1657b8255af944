"""Vectorized stream correlators.

Port of ``grtpu.digital.correlate``.  Analogs:
  * digital_correlate_access_code_bb (gr-digital/lib/): bit stream in,
    flag stream out — flag bit set on the bit FOLLOWING a <=threshold-error
    access-code match.
  * gr_correlate_access_code_tag_bb: same detection, emitted as stream tags.
  * gr_pn_correlator_cc, gr_simple_correlator / gr_simple_framer.

The reference shifts one 64-bit register per sample; here the whole
time-block's sliding mismatch counts come from one +-1 correlation (a
float32 FIR with the code as taps; its sums of +-1 over at most 64 terms
are exact integers, which is why TF32 must stay off: ``fir_filter``'s f32
mode refuses to run under it).

Nothing here reads the device from the host inside a block's ``apply``:
static-size selections (grtpu's ``jnp.nonzero(..., size=)``) are ``topk``
on a recency score, and grtpu's scans over candidates are Python loops of a
static count, so a chunk captures into one CUDA graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from grtpu_torch.ops.fir import fir_filter
from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.utils.device import constant


@functools.lru_cache(maxsize=64)
def _code_taps(code: bytes, device: torch.device) -> torch.Tensor:
    """The access code as reversed +-1 float32 taps on ``device``."""
    c = np.frombuffer(code, np.uint8).astype(np.float32) * 2 - 1
    return torch.from_numpy(c[::-1].copy()).to(device)


def access_code_detect(bits: torch.Tensor, code_bits: np.ndarray,
                       threshold: int = 0) -> torch.Tensor:
    """Sliding access-code match over a bit stream.

    bits: (n + L - 1,) uint8 carrying L-1 history.
    Returns (n,) uint8 flags: flag[i] == 1 iff the L bits ENDING at i (i.e.
    bits[i-L+1..i] in stream coordinates) match within threshold errors —
    the reference's semantics of flagging on the last code bit.
    """
    code = np.asarray(code_bits, np.uint8)
    s = bits.to(torch.float32) * 2 - 1
    # correlation with the code as FIR taps (convolution orientation needs
    # the reversed code)
    corr = fir_filter(s, _code_taps(code.tobytes(), bits.device), 1)
    L = len(code)
    errs = (L - corr) / 2
    return (errs <= threshold + 0.5).to(torch.uint8)


class CorrelateAccessCode(Block):
    """digital_correlate_access_code_bb: bits in (LSB), bits out with flag
    in bit 1 (0x2) on the bit following a match (payload start)."""

    def __init__(self, access_code_bits, threshold: int = 0, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        code = np.asarray(access_code_bits, np.uint8)
        self.history = len(code) + 1
        super().__init__(name)
        self.code = code
        self.threshold = threshold

    def apply(self, state, x):
        # flags for windows ending at the PREVIOUS bit -> flag on following
        flags = access_code_detect(x[:-1] & 1, self.code, self.threshold)
        data = x[self.history - 1:] & 1
        return state, data | (flags << 1)


class CorrelateAccessCodeTag(Block):
    """Access-code detector emitting stream Tags instead of flag bits
    (the gr 3.6-era digital_correlate_access_code_tag_bb shape, built on
    the same sliding correlator as CorrelateAccessCode): bits pass through
    unchanged; a Tag(key, True) is placed on the first payload bit after
    each code match."""

    emits_tags = True
    device_tags = True

    def __init__(self, access_code_bits, threshold: int = 0,
                 key: str = "access_code", name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        code = np.asarray(access_code_bits, np.uint8)
        self.history = len(code) + 1
        super().__init__(name)
        self.code = code
        self.threshold = threshold
        self.key = key

    def apply(self, state, x):
        return state, x[self.history - 1:] & 1

    def apply_tagged(self, state, x):
        # detection on the device: the same sliding +-1 correlation,
        # reduced to a fixed-size offset record (device_tags; the make_tags
        # path below does the same on the host)
        out = x[self.history - 1:] & 1
        flags = access_code_detect(x[:-1] & 1, self.code, self.threshold)
        offs, _ = self._tag_topk(flags > 0, out.shape[0])
        return state, out, {"offset": offs}

    def tags_from_device(self, rec, start_in, start_out):
        from grtpu_torch.runtime.tags import Tag

        return [Tag(start_out + int(o), self.key, True, self.name)
                for o in rec["offset"] if o >= 0]

    def make_tags(self, ins, outs, start_in, start_out):
        from grtpu_torch.runtime.tags import Tag

        bits = (np.asarray(ins[0]) & 1).astype(np.float32) * 2 - 1
        code = self.code.astype(np.float32) * 2 - 1
        L = len(code)
        # window of L bits ENDING at delivered index i matches -> payload
        # starts at the next bit.  Output item j corresponds to delivered
        # index j + history - 1 = j + L.
        corr = np.convolve(bits, code[::-1], mode="valid")
        errs = (L - corr) / 2
        hits = np.flatnonzero(errs <= self.threshold + 0.5)
        n_out = len(np.asarray(outs[0]))
        # window ends at delivered index h+L-1; payload = h+L; output
        # coordinate j = (h+L) - L = h
        return [Tag(start_out + int(h), self.key, True, self.name)
                for h in hits if 0 <= h < n_out]


class PnCorrelator(Block):
    """gr_pn_correlator_cc: correlate against a +-1 PN sequence, one output
    per full period (decimating by the sequence length)."""

    def __init__(self, degree: int, mask: int = 0, seed: int = 1, name=None):
        from grtpu_torch.digital.lfsr import GLFSR

        length = (1 << degree) - 1
        g = GLFSR(mask if mask else GLFSR.default_mask(degree), seed)
        pn = np.array([2 * g.next_bit() - 1 for _ in range(length)], np.float32)
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.decim = length
        super().__init__(name)
        self.pn = pn
        self.length = length

    def apply(self, state, x):
        g = x.reshape(-1, self.length)
        pn = constant(self, "pn", x.device)
        return state, (g * pn[None, :]).sum(dim=1) / self.length


# ---------------------------------------------------------------------------
# gr_simple_framer / gr_simple_correlator
# ---------------------------------------------------------------------------

GRSF_SYNC = 0xACDDA4E2F28C20FC          # gr_simple_framer_sync.h:42
GRSF_OVERHEAD = 10                      # 8 sync + 1 seqno + 1 tail pad
_OVERSAMPLE = 8                         # gr_simple_correlator.h:43
_AVG_PERIOD = 512
_THRESHOLD = 3                          # max sync-bit errors
_SYNC_BITS = np.array([(GRSF_SYNC >> (63 - i)) & 1 for i in range(64)],
                      np.float32) * 2 - 1


class SimpleFramer(Block):
    """gr_simple_framer (gr_simple_framer.cc:41-95): per payload block emit
    8 sync bytes + 1 running seqno + payload + one 0x55 pad byte."""

    def __init__(self, payload_bytesize: int, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        self.decim = int(payload_bytesize)
        self.interp = int(payload_bytesize) + GRSF_OVERHEAD
        super().__init__(name)
        self.payload = int(payload_bytesize)
        self.sync = np.array([(GRSF_SYNC >> (8 * (7 - i))) & 0xFF
                              for i in range(8)], np.uint8)

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)   # seqno

    def apply(self, state, x):
        blocks = x.reshape(-1, self.payload)
        nb = blocks.shape[0]
        seq = (state + torch.arange(nb, dtype=torch.int32,
                                    device=x.device)) % 256
        hdr = constant(self, "sync", x.device).expand(nb, 8)
        out = torch.cat([
            hdr,
            seq[:, None].to(torch.uint8),
            blocks,
            torch.full((nb, 1), 0x55, dtype=torch.uint8, device=x.device),
        ], dim=1)
        return (state + nb) % 256, out.reshape(-1)


def _first_true(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Indices of the first ``k`` True values of a 1-D bool mask, ascending,
    padded with ``fill`` (``jnp.nonzero(mask, size=k, fill_value=fill)``):
    ``topk`` on a recency score, unique for hits, so no shape depends on
    the data."""
    n = mask.shape[0]
    score = torch.where(mask, n - torch.arange(n, device=mask.device), 0)
    kk = min(k, n)
    vals, _ = torch.topk(score, kk)
    idx = torch.where(vals > 0, n - vals, fill)
    if kk < k:
        idx = torch.cat([idx, idx.new_full((k - kk,), fill)])
    return idx


def simple_correlator_burst(x: torch.Tensor, payload_bytesize: int,
                            max_packets: int = 8):
    """Burst-mode gr_simple_correlator (gr_simple_correlator.cc:139-230):
    8x-oversampled float stream -> framed packets.

    The reference runs a per-sample LOOKING/UNDER_THRESHOLD/LOCKED state
    machine with one 64-bit shift register per oversample phase.  Here the
    whole chunk is processed at once: every position's sync hamming
    distance comes from one 64-tap stride-8 correlation (shifted adds), run
    centers and sampling phases are computed vectorially, and only the
    accept/skip ordering is a loop over the (static count of) candidate
    runs.  Divergence (grtpu's): the slicer threshold is the causal
    512-sample rolling mean (the reference slices with the PREVIOUS
    packet's halved average and freezes it during LOCKED).

    Returns (payloads, seqnos, valid): (max_packets, payload_bytesize)
    uint8, (max_packets,) int32, (max_packets,) bool.
    """
    T = x.shape[0]
    dev = x.device
    bblen = (payload_bytesize + 1) * 8          # seqno + payload, in bits
    # causal rolling mean over the last AVG_PERIOD samples (zero-padded,
    # matching the reference's zero-initialized avgbuf)
    csum = torch.cumsum(x, 0)
    lag = torch.cat([x.new_zeros(_AVG_PERIOD), csum[:-_AVG_PERIOD]])[:T]
    avg = (csum - lag) / _AVG_PERIOD
    bits = torch.where(x >= avg, 1.0, -1.0)

    # hamming distance of the 64-bit stride-8 word ENDING at each sample
    span = _OVERSAMPLE * 63
    bpad = torch.cat([bits.new_zeros(span), bits])
    corr = torch.zeros(T, dtype=torch.float32, device=dev)
    for k in range(64):                          # 64 shifted adds
        corr = corr + float(_SYNC_BITS[k]) * bpad[k * _OVERSAMPLE:
                                                  k * _OVERSAMPLE + T]
    dist = (64.0 - corr) / 2.0
    idx = torch.arange(T, dtype=torch.int64, device=dev)
    good = (dist <= _THRESHOLD + 0.5) & (idx >= span)   # no zero-pad syncs

    prev = torch.cat([good.new_zeros(1), good[:-1]])
    starts = good & ~prev                        # first below-threshold
    ends = ~good & prev                          # first above (lock point)
    last_start = torch.cummax(torch.where(starts, idx, -1), 0).values
    cand = _first_true(ends, max_packets * 2, T)
    s_j = torch.where(cand < T, last_start[torch.clamp(cand, max=T - 1)], 0)
    e_j = cand

    # center-of-goodness oversample phase (enter_locked,
    # gr_simple_correlator.cc:104-118, incl. its +3 fudge)
    delta = (e_j - s_j) % _OVERSAMPLE
    center = (s_j + delta // 2 + 3) % _OVERSAMPLE
    n0 = e_j + 1 + (center - (e_j + 1)) % _OVERSAMPLE
    n_last = n0 + _OVERSAMPLE * (bblen - 1)
    fits = (cand < T) & (n_last < T)

    # greedy accept: skip candidates whose run started inside a previous
    # accepted packet (the state machine is LOCKED there)
    next_free = torch.full((), -1, dtype=torch.int64, device=dev)
    oks = []
    for j in range(s_j.shape[0]):
        ok = fits[j] & (s_j[j] >= next_free)
        next_free = torch.where(ok, n_last[j] + 1, next_free)
        oks.append(ok)
    ok = torch.stack(oks)
    order = torch.argsort((~ok).to(torch.int8), stable=True)  # accepted first
    take = order[:max_packets]
    n0_t, ok_t = n0[take], ok[take]

    # sample + slice the packet bits at the locked phase, frozen threshold
    bit_idx = n0_t[:, None] + _OVERSAMPLE * torch.arange(bblen, device=dev)[None, :]
    bit_idx = torch.clamp(bit_idx, 0, T - 1)
    thresh = torch.clamp(avg[torch.clamp(e_j[take], 0, T - 1)], -1.0, 1.0)
    pkt_bits = (x[bit_idx] >= thresh[:, None]).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=dev)
    pkt_bytes = (pkt_bits.reshape(max_packets, bblen // 8, 8)
                 * weights[None, None, :]).sum(-1)
    seqnos = torch.where(ok_t, pkt_bytes[:, 0], -1).to(torch.int32)
    payloads = (pkt_bytes[:, 1:] * ok_t[:, None]).to(torch.uint8)
    return payloads, seqnos, ok_t


class SimpleCorrelator(Block):
    """gr_simple_correlator as a variable-rate block: float samples in,
    recovered payload bytes out as (y_padded, n_valid) per the
    mask-and-compact convention (packets fully inside the chunk)."""

    variable_rate = True

    def __init__(self, payload_bytesize: int, max_packets: int = 8,
                 name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.payload = int(payload_bytesize)
        self.max_packets = int(max_packets)

    def apply(self, state, x):
        payloads, _seq, ok = simple_correlator_burst(
            x, self.payload, self.max_packets)
        return state, (payloads.reshape(-1),
                       ok.sum().to(torch.int32) * self.payload)


class FramerSink(Block):
    """gr_framer_sink_1 name shim (gnuradio-core/src/lib/general/
    gr_framer_sink_1.cc): consumes the CorrelateAccessCode output bit
    stream (data in bit 0, "code found" flag in bit 1 marking the first
    header bit), parses the 2x16-bit header, and posts one Message per
    frame — raw (still-whitened) payload bytes, exactly where the
    reference crosses into Python via gr_msg_queue.

    The streaming role is covered by the variable-rate PacketDecoder
    block; this shim exists so reference users find the name.  Frames are
    parsed from the captured stream when the executor finishes a run and
    delivered through ``self.msgq``.
    """

    def __init__(self, msgq=None, name=None):
        from grtpu_torch.runtime.msg import MsgQueue

        self.in_ports = (Port(torch.uint8),)
        self.out_ports = ()
        super().__init__(name)
        self.msgq = msgq if msgq is not None else MsgQueue()
        self._captured = None

    def apply(self, state, x):
        return state, ()

    @property
    def captured(self):
        return self._captured

    @captured.setter
    def captured(self, vals):
        self._captured = vals
        if vals:
            self._parse(vals[0].cpu().numpy().astype(np.uint8))

    def _parse(self, stream: np.ndarray):
        from grtpu_torch.digital import packet as pu
        from grtpu_torch.runtime.msg import Message

        flags = np.flatnonzero(stream & 0x2)
        bits = stream & 1
        n = len(bits)
        pos = 0
        for f in flags:
            if f < pos or f + 32 > n:
                continue
            parsed = pu.parse_header(pu.bits_to_bytes(bits[f: f + 32]))
            if parsed is None:
                continue
            plen, _off = parsed
            end = f + 32 + plen * 8
            if end > n:
                continue
            payload = pu.bits_to_bytes(bits[f + 32: end])
            self.msgq.insert_tail(Message(payload=payload))
            pos = end


class PacketSink(FramerSink):
    """gr_packet_sink name shim (gnuradio-core/src/lib/general/
    gr_packet_sink.cc): like FramerSink but hunts the access code itself
    on a raw demodulated bit stream (sync_vector = code bits, threshold =
    max bit errors), then parses header + payload and posts the raw
    payload bytes to ``self.msgq``."""

    def __init__(self, sync_vector=None, msgq=None, threshold: int = 0,
                 name=None):
        super().__init__(msgq=msgq, name=name)
        from grtpu_torch.digital import packet as pu

        self.code = (np.asarray(sync_vector, np.uint8)
                     if sync_vector is not None and
                     len(np.atleast_1d(sync_vector))
                     else pu.DEFAULT_ACCESS_CODE_BITS)
        self.threshold = 0 if threshold in (None, -1) else int(threshold)

    def _parse(self, stream: np.ndarray):
        from grtpu_torch.digital import packet as pu
        from grtpu_torch.runtime.msg import Message

        bits = stream & 1
        consumed = 0
        while True:
            idx = pu.find_access_code(bits[consumed:], self.code,
                                      self.threshold)
            if idx is None:
                break
            base = consumed + idx
            if base + 32 > len(bits):
                break
            parsed = pu.parse_header(pu.bits_to_bytes(bits[base: base + 32]))
            if parsed is None:
                consumed = base + 1
                continue
            plen, _off = parsed
            end = base + 32 + plen * 8
            if end > len(bits):
                break
            self.msgq.insert_tail(
                Message(payload=pu.bits_to_bytes(bits[base + 32: end])))
            consumed = end
