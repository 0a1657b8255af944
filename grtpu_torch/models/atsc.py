"""ATSC 8-VSB baseband codec subset (config #5).

Port of ``grtpu.models.atsc``: the randomizer, interleavers, RS and the
trellis encoder are host numpy (copies of grtpu's, identical output); the
12-phase trellis decode is one batched Viterbi on the device, which on the
card is one launch of the hand kernel ``viterbi_fwd``.

Analogs (gr-atsc, SURVEY.md §2.8): atsci_randomizer (16-bit LFSR whitening
of MPEG transport packets), RS(207,187) (via grtpu_torch.fec.rs), the (52,4)
convolutional byte interleaver, the 12-way-interleaved 2/3-rate trellis
coder (differential precoder + 4-state feedback encoder -> 8-level
symbols), and the matching Viterbi receive path
(atsci_viterbi_decoder's 12-phase structure).

Behavioral spec (studied from the reference, re-derived as logic):
  randomizer: Galois LFSR, preload 0x018F, mask 0xA638, output byte from
  taps {15,13,12,9,5,4,3,2} of the state; XOR applied to the 187
  post-sync bytes of each packet.
  trellis (A/53): z2 = x2 XOR p;  p' = z2        (differential precoder)
                  z1 = x1;  z0 = m0;  m0' = x1 XOR m1;  m1' = m0
  symbol = (z2 z1 z0) -> level 2*sym - 7; symbols cycle through 12
  independent encoders.

RF-layer specifics (segment/field sync insertion, pilot, NTSC rejection
filter) are out of scope — this is the coding stack over clean baseband.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grtpu_torch.fec.rs import rs_atsc
from grtpu_torch.trellis.algorithms import calc_metric_euclidean, viterbi
from grtpu_torch.trellis.fsm import FSM
from grtpu_torch.utils.device import resolve

MPEG_SYNC = 0x47
DATA_LEN = 187  # bytes per packet after sync removal
RS_PARITY = 20
SEG_LEN = DATA_LEN + RS_PARITY  # 207 bytes per RS-coded segment
INTERLEAVE_B = 52
INTERLEAVE_M = 4
NUM_TRELLIS = 12


# ----------------------------------------------------------------- randomizer
class Randomizer:
    """atsci_randomizer semantics."""

    PRELOAD = 0x018F
    MASK = 0xA638
    _TAPS = [(0x8000, 0x01), (0x2000, 0x02), (0x1000, 0x04), (0x0200, 0x08),
             (0x0020, 0x10), (0x0010, 0x20), (0x0008, 0x40), (0x0004, 0x80)]

    def __init__(self):
        self.state = self.PRELOAD

    def reset(self):
        self.state = self.PRELOAD

    def _output(self) -> int:
        out = 0
        for mask, bit in self._TAPS:
            if self.state & mask:
                out |= bit
        return out

    def _clk(self):
        if self.state & 1:
            self.state = ((self.state ^ self.MASK) >> 1) | 0x8000
        else:
            self.state >>= 1

    def sequence(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.uint8)
        for i in range(n):
            out[i] = self._output()
            self._clk()
        return out

    SEGS_PER_FIELD = 312
    _PRBS_FIELD: "np.ndarray | None" = None

    @classmethod
    def _field_prbs(cls) -> np.ndarray:
        """One field's PRBS bytes, computed once: the LFSR reloads
        PRELOAD at every field start, so every field sees the SAME
        sequence — the per-byte python LFSR loop (0.3-0.5 s/field) runs
        exactly once per process."""
        if cls._PRBS_FIELD is None:
            cls._PRBS_FIELD = cls().sequence(cls.SEGS_PER_FIELD * DATA_LEN)
        return cls._PRBS_FIELD

    def _field_sequence(self, n_packets: int) -> np.ndarray:
        """PRBS bytes for n_packets, with the A/53 per-field reset: the LFSR
        reloads PRELOAD at the start of every 312-packet data field."""
        prbs = self._field_prbs()
        chunks = []
        done = 0
        while done < n_packets:
            self.reset()
            n = min(self.SEGS_PER_FIELD, n_packets - done)
            chunks.append(prbs[: n * DATA_LEN])
            done += n
        return np.concatenate(chunks).reshape(-1, DATA_LEN)

    def randomize_packets(self, packets: np.ndarray) -> np.ndarray:
        """(n, 188) packets with sync byte -> (n, 187) whitened payloads."""
        pk = np.asarray(packets, np.uint8)
        assert pk.ndim == 2 and pk.shape[1] == DATA_LEN + 1
        assert (pk[:, 0] == MPEG_SYNC).all()
        return pk[:, 1:] ^ self._field_sequence(pk.shape[0])

    def derandomize_packets(self, payloads: np.ndarray) -> np.ndarray:
        pl = np.asarray(payloads, np.uint8)
        out = np.zeros((pl.shape[0], DATA_LEN + 1), np.uint8)
        out[:, 0] = MPEG_SYNC
        out[:, 1:] = pl ^ self._field_sequence(pl.shape[0])
        return out


# ---------------------------------------------------------------- interleaver
class ConvolutionalInterleaver:
    """(B=52, M=4) byte interleaver (atsci_data_interleaver): branch i
    delays by i*M bytes; commutated byte-by-byte."""

    def __init__(self, b: int = INTERLEAVE_B, m: int = INTERLEAVE_M):
        self.b, self.m = b, m
        self.lines = [np.zeros(i * m, np.uint8) for i in range(b)]
        self.ptr = 0

    def process(self, data: np.ndarray) -> np.ndarray:
        return _commutated_fifo_process(self, data)


def _commutated_fifo_process(self, data: np.ndarray) -> np.ndarray:
    """Shared vectorized engine for the convolutional (de)interleavers.

    The reference commutates one byte per branch FIFO; per call that is a
    per-byte python loop (round-5: the ATSC transport bottleneck at ~0.5
    Msym/s).  Each branch i only ever sees the strided sub-stream of its
    own commutator slots, and its FIFO is a pure delay of len(line)
    bytes of that sub-stream — so the whole call is B strided
    slices/concats, byte-exact with the loop (state carried
    identically)."""
    data = np.asarray(data, np.uint8)
    n = len(data)
    out = np.empty(n, np.uint8)
    b = self.b
    for i in range(b):
        # global positions of branch i this call
        first = (i - self.ptr) % b
        sub = data[first::b]
        if len(sub) == 0:
            continue
        line = self.lines[i]
        if len(line) == 0:
            out[first::b] = sub
        else:
            buf = np.concatenate([line, sub])
            out[first::b] = buf[: len(sub)]
            self.lines[i] = buf[len(sub):]
    self.ptr = (self.ptr + n) % b
    return out


class ConvolutionalDeinterleaver:
    """Matching deinterleaver: branch i delays by (B-1-i)*M bytes; total
    pipeline delay B*(B-1)*M bytes."""

    def __init__(self, b: int = INTERLEAVE_B, m: int = INTERLEAVE_M):
        self.b, self.m = b, m
        self.lines = [np.zeros((b - 1 - i) * m, np.uint8) for i in range(b)]
        self.ptr = 0

    def process(self, data: np.ndarray) -> np.ndarray:
        return _commutated_fifo_process(self, data)


TOTAL_INTERLEAVE_DELAY = INTERLEAVE_B * (INTERLEAVE_B - 1) * INTERLEAVE_M


# -------------------------------------------------------------------- trellis
def atsc_trellis_fsm() -> FSM:
    """8-state FSM from the derived A/53 recursion (state = (p, m1, m0),
    input = (x2, x1), output = (z2, z1, z0))."""
    NS = np.zeros((8, 4), np.int32)
    OS = np.zeros((8, 4), np.int32)
    for s in range(8):
        p, m1, m0 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for i in range(4):
            x2, x1 = (i >> 1) & 1, i & 1
            z2 = x2 ^ p
            z1 = x1
            z0 = m0
            p2, m12, m02 = z2, m0, x1 ^ m1
            NS[s, i] = (p2 << 2) | (m12 << 1) | m02
            OS[s, i] = (z2 << 2) | (z1 << 1) | z0
    return FSM(4, 8, 8, NS.reshape(-1), OS.reshape(-1))


_FSM = atsc_trellis_fsm()
LEVELS = np.arange(8) * 2.0 - 7.0  # 8-VSB levels


def trellis_encode(dibits: np.ndarray,
                   states: np.ndarray | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """12-way interleaved trellis encode: dibit stream -> 8-level symbols.

    dibits length must be a multiple of 12.  Returns (levels, states')."""
    d = np.asarray(dibits, np.int32)
    assert len(d) % NUM_TRELLIS == 0
    if states is None:
        states = np.zeros(NUM_TRELLIS, np.int32)
    states = states.copy()
    out = np.zeros(len(d), np.int32)
    NS, OS = _FSM.NS, _FSM.OS
    per = d.reshape(-1, NUM_TRELLIS)
    for ph in range(NUM_TRELLIS):
        s = states[ph]
        col = per[:, ph]
        for t, x in enumerate(col):
            out[t * NUM_TRELLIS + ph] = OS[s, x]
            s = NS[s, x]
        states[ph] = s
    return LEVELS[out], states


def trellis_decode(levels: np.ndarray, device=None) -> np.ndarray:
    """12-phase Viterbi decode: soft 8-level symbols -> dibit stream.

    The 12 interleaved trellis phases are independent, so all 12 decode as
    ONE batched Viterbi on ``device`` (the card unless named; the
    reference's atsci_viterbi_decoder mux loops them serially)."""
    x = np.asarray(levels, np.float32)
    assert len(x) % NUM_TRELLIS == 0
    per_phase = torch.from_numpy(
        np.ascontiguousarray(x.reshape(-1, NUM_TRELLIS).T)).to(resolve(device))
    out = trellis_decode_device(per_phase)
    return out.cpu().numpy().T.reshape(-1).astype(np.int32)


def trellis_decode_device(per_phase: torch.Tensor) -> torch.Tensor:
    """Device half of trellis_decode: (12, T) per-phase soft symbols ->
    (12, T) int32 dibit decisions, one batched Viterbi (``viterbi_fwd`` on
    the card)."""
    pts = torch.from_numpy(LEVELS.astype(np.float32)).to(per_phase.device)
    return viterbi(_FSM, calc_metric_euclidean(per_phase, pts), 0, -1)


# ------------------------------------------------------------------- pipeline
def bytes_to_dibits(data: np.ndarray) -> np.ndarray:
    """MSB-first dibit unpacking (atsc byte -> 4 symbols)."""
    b = np.asarray(data, np.uint8)
    shifts = np.array([6, 4, 2, 0])
    return ((b[:, None] >> shifts[None, :]) & 3).reshape(-1)


def dibits_to_bytes(dibits: np.ndarray) -> np.ndarray:
    d = np.asarray(dibits, np.uint8).reshape(-1, 4)
    return ((d[:, 0] << 6) | (d[:, 1] << 4) | (d[:, 2] << 2)
            | d[:, 3]).astype(np.uint8)


class AtscTransmitter:
    """randomize -> RS(207,187) -> interleave -> trellis -> 8 levels.

    Host numpy, as in grtpu; its carried state (the 12 trellis states and
    the interleaver's branch lines and commutator) can be loaded from
    grtpu's with :meth:`load_state`."""

    def __init__(self):
        self.randomizer = Randomizer()
        self.rs = rs_atsc()
        self.interleaver = ConvolutionalInterleaver()
        self.trellis_states = np.zeros(NUM_TRELLIS, np.int32)

    def load_state(self, trellis_states, lines=None, ptr=None):
        """Resume from another transmitter's state given as numpy arrays
        (grtpu's ``trellis_states``, ``interleaver.lines``,
        ``interleaver.ptr``)."""
        self.trellis_states = np.array(trellis_states, np.int32)
        if lines is not None:
            self.interleaver.lines = [np.array(v, np.uint8) for v in lines]
        if ptr is not None:
            self.interleaver.ptr = int(ptr)

    def process(self, packets: np.ndarray) -> np.ndarray:
        payloads = self.randomizer.randomize_packets(packets)
        segs = np.stack([self.rs.encode_codeword(p) for p in payloads])
        inter = self.interleaver.process(segs.reshape(-1))
        dib = bytes_to_dibits(inter)
        levels, self.trellis_states = trellis_encode(dib, self.trellis_states)
        return levels


class AtscReceiver:
    """trellis decode (on ``device``, the card unless named) -> deinterleave
    -> RS decode -> derandomize (host numpy)."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self.randomizer = Randomizer()
        self.rs = rs_atsc()
        self.deinterleaver = ConvolutionalDeinterleaver()

    def process(self, levels: np.ndarray) -> Tuple[np.ndarray, int]:
        """Returns (packets, n_uncorrectable).  Input must cover whole
        segments plus the interleaver flush (callers feed the full field)."""
        return self._transport(trellis_decode(levels, self.device))

    def _transport(self, dib):
        bytes_ = dibits_to_bytes(dib)
        deint = self.deinterleaver.process(bytes_)
        # drop the interleaver pipeline delay
        deint = deint[TOTAL_INTERLEAVE_DELAY:]
        nseg = len(deint) // SEG_LEN
        if nseg == 0:
            return np.zeros((0, DATA_LEN + 1), np.uint8), 0
        segs = deint[: nseg * SEG_LEN].reshape(nseg, SEG_LEN)
        # vectorized syndrome screen; BM runs only on errored segments
        fixed, nerr = self.rs.decode_batch(segs)
        bad = int((nerr < 0).sum())
        keep = np.where((nerr >= 0)[:, None], fixed, segs.astype(np.uint8))
        packets = keep[:, :DATA_LEN]
        return self.randomizer.derandomize_packets(packets), bad
