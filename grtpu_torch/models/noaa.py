"""NOAA HRPT receive components.

Port of ``grtpu.models.noaa``.  Analogs (gr-noaa): noaa_hrpt_pll_cf
(carrier recovery for the split-phase PM downlink), noaa_hrpt_deframer
(frame sync on the 60-bit sync word + minor-frame extraction),
noaa_hrpt_decoder (10-bit word unpacking).

HRPT: 665.4 kbit/s biphase; frames of 11090 10-bit words starting with the
fixed 6-word sync pattern.

``HrptPll`` is a per-sample loop (:func:`grtpu_torch.runtime.step_graph.
step_scan`).  ``HrptDeframer`` computes grtpu's per-sample state machine a
chunk at a time, with no loop over samples (see the class).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from grtpu_torch.ops import dsp
from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.runtime.step_graph import step_scan
from grtpu_torch.utils.device import constant

# The 60-bit HRPT minor-frame sync: 6 x 10-bit words (A/B standard pattern)
HRPT_SYNC_WORDS = (0x0284, 0x016F, 0x035C, 0x019D, 0x020F, 0x0095)
HRPT_MINOR_FRAME_WORDS = 11090
HRPT_BITS_PER_WORD = 10


def sync_bits() -> np.ndarray:
    bits = []
    for w in HRPT_SYNC_WORDS:
        bits.extend((w >> (9 - i)) & 1 for i in range(10))
    return np.array(bits, np.uint8)


class HrptPll(Block):
    """noaa_hrpt_pll_cf: PM carrier recovery emitting the baseband data
    that rides the phase.

    Exact loop semantics of noaa_hrpt_pll_cf.cc:60-83 — per sample the NCO
    is mixed out and the *imaginary* part emitted, the phase error is
    ``wrap(angle(x) - phase)``, the frequency integrator is clipped to
    ``±max_offset`` and the phase advanced by ``alpha*err + freq``.

    The loop carries only (phase, freq): ``angle(x)`` is taken for the
    whole chunk before it, and the output ``imag(x * exp(-j*phase))`` after
    it from the phases the loop recorded, so a step is ~13 scalar ops."""

    def __init__(self, alpha: float = 0.01, beta: Optional[float] = None,
                 max_offset: float = 0.1, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)
        self.alpha = float(alpha)
        self.beta = float(beta) if beta is not None else self.alpha ** 2 / 4
        self.max_offset = float(max_offset)

    def init_state(self):
        return (torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.float32))

    def apply(self, state, x):
        alpha, beta, moff = self.alpha, self.beta, self.max_offset
        ang = torch.atan2(x.imag, x.real)

        def step(s, a):
            phase, freq = s
            err = dsp.phase_wrap(a - phase)
            freq = torch.clamp(freq + beta * err, -moff, moff)
            return (dsp.phase_wrap(phase + alpha * err + freq), freq), phase

        phases = torch.empty_like(ang)
        st = step_scan(step, state, ang, phases)
        y = x.imag * torch.cos(phases) - x.real * torch.sin(phases)
        return st, y


def deframe(bits: np.ndarray, max_errors: int = 4
            ) -> List[np.ndarray]:
    """noaa_hrpt_deframer: locate sync patterns, slice minor frames of
    11090 10-bit words.  Returns the list of complete frames (as word
    arrays)."""
    pat = sync_bits()
    b = np.asarray(bits, np.int8)
    if len(b) < len(pat):
        return []
    s = 2 * b.astype(np.int32) - 1
    c = 2 * pat.astype(np.int32) - 1
    corr = np.correlate(s, c, mode="valid")
    errs = (len(pat) - corr) // 2
    starts = np.nonzero(errs <= max_errors)[0]
    frames = []
    frame_bits = HRPT_MINOR_FRAME_WORDS * HRPT_BITS_PER_WORD
    last = -frame_bits
    for st in starts:
        if st < last + frame_bits:
            continue
        if st + frame_bits <= len(b):
            frames.append(decode_words(b[st: st + frame_bits]))
            last = st
    return frames


def decode_words(bits: np.ndarray) -> np.ndarray:
    """noaa_hrpt_decoder: MSB-first 10-bit word unpack."""
    b = np.asarray(bits, np.int64).reshape(-1, HRPT_BITS_PER_WORD)
    shifts = np.arange(9, -1, -1)
    return (b << shifts[None, :]).sum(axis=1).astype(np.int32)


def encode_words(words: np.ndarray) -> np.ndarray:
    w = np.asarray(words, np.int64)
    shifts = np.arange(9, -1, -1)
    return ((w[:, None] >> shifts[None, :]) & 1).reshape(-1).astype(np.uint8)


# HRPT_MINOR_FRAME_SYNC (noaa_hrpt.h:33 = 0x0A116FD719D83C95, low 60 bits)
_SYNC60 = 0x0A116FD719D83C95 & ((1 << 60) - 1)
_N_DATA = HRPT_MINOR_FRAME_WORDS - len(HRPT_SYNC_WORDS)
_FRAME_SAMPLES = 2 * _N_DATA * HRPT_BITS_PER_WORD     # 221,680


class HrptDeframer(Block):
    """noaa_hrpt_deframer as a variable-rate graph block.

    Input: hard bits (uint8) at 2 samples/bit; output: 10-bit minor-frame
    words (int16, sync words included), exactly the state machine of
    noaa_hrpt_deframer.cc:69-131 as grtpu runs it one sample a step:
    mid-bit alternation (wait for a transition while idle, take every other
    sample once synced), a 60-bit shifter matched against
    HRPT_MINOR_FRAME_SYNC, then 11084 data words of 10 MSB-first bits.

    The port computes a chunk at a time, in up to ``ceil(n / 221680) + 1``
    rounds of two parts with static shapes (so ``device_loop`` captures a
    chunk):
      * synced: the frame's remaining bits are the samples p0, p0+2, ... up
        to the frame's end; words are gathered 10 bits at a time (the
        carried partial word first), and the shifter is left untouched;
      * idle, from the sample after the frame's end: ``mid`` resets to 1
        after every non-transition and flips at each transition, so it is
        the parity of the run of transitions before a sample (the carried
        ``mid`` for a run that started before the search did); the
        processed samples are the transitions at mid, and a hit is the
        first processed bit whose last 60 processed bits (the carried
        shifter first) equal the sync word.
    The 60-bit shifter, two uint32 lanes in grtpu, is one int64 here."""

    variable_rate = True

    def __init__(self, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.int16),)
        super().__init__(name)
        self._sync_words = np.asarray(HRPT_SYNC_WORDS, np.int64)
        self._sync_bits = sync_bits().astype(np.int64)
        self._pow60 = (1 << np.arange(59, -1, -1)).astype(np.int64)

    @property
    def nominal_rate(self):
        # once synced: one 10-bit word per 20 input samples
        return 1.0 / (2 * HRPT_BITS_PER_WORD)

    def max_out_for(self, n_delivered: int) -> int:
        return 6 * n_delivered

    def init_state(self):
        i64 = lambda v: torch.tensor(v, dtype=torch.int64)
        return dict(mid=torch.ones((), dtype=torch.bool), last=i64(0),
                    synced=torch.zeros((), dtype=torch.bool), sh=i64(0),
                    word=i64(0), bitc=i64(0), wordc=i64(0))

    def apply(self, state, x):
        dev = x.device
        n = x.shape[0]
        b = (x & 1).to(torch.int64)
        j = torch.arange(n, device=dev)
        diff = b ^ torch.cat([state["last"].reshape(1), b[:-1]])
        sbits = constant(self, "_sync_bits", dev)
        pow60 = constant(self, "_pow60", dev)
        syncw = constant(self, "_sync_words", dev)
        nslot = n // 20 + 2
        slot = torch.arange(nslot, device=dev)[:, None]
        q = torch.arange(10, device=dev)[None, :]
        y = torch.zeros(6 * n + 1, dtype=torch.int64, device=dev)
        dump = 6 * n

        pos = torch.zeros((), dtype=torch.int64, device=dev)
        midp = state["mid"]
        synced, sh = state["synced"], state["sh"]
        word, bitc, wordc = state["word"], state["bitc"], state["wordc"]
        off = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(-(-n // _FRAME_SAMPLES) + 1):
            # ---- synced: the rest of the current frame
            p0 = pos + (~midp).to(torch.int64)
            avail = ((n - p0 + 1) // 2).clamp(min=0)
            rem = (wordc - 1) * HRPT_BITS_PER_WORD + bitc
            take = torch.where(synced, torch.minimum(rem, avail), 0)
            cb = HRPT_BITS_PER_WORD - bitc          # bits already in `word`
            k = 10 * slot + q - cb                  # new-bit index, (S, 10)
            got = b[(p0 + 2 * k).clamp(0, n - 1)]
            old = (word >> (cb - 1 - q).clamp(min=0)) & 1
            bit = torch.where(k < 0, old, torch.where(k < take, got, 0))
            val = (bit << (9 - q)).sum(1)                            # (S,)
            tb = cb + take
            nc = torch.where(synced, tb // 10, 0)   # words completed
            y.index_copy_(0, torch.where(slot[:, 0] < nc, off + slot[:, 0],
                                         dump), val)
            off = off + nc
            done = synced & (take == rem)           # the frame's last bit
            keep = synced & ~done                   # still in the frame
            cbn = tb % 10
            # a 0-d index would be read on the host: index with one element
            partial = val.index_select(0, nc.clamp(max=nslot - 1).reshape(1))
            word = torch.where(keep, partial[0] >> (10 - cbn),
                               torch.where(done, 0, word))
            bitc = torch.where(keep, 10 - cbn, torch.where(done, 10, bitc))
            wordc = torch.where(synced, wordc - nc, wordc)
            mid_kept = (n - p0) % 2 == 0
            ps = torch.where(done, p0 + 2 * take - 1, pos)
            mp = torch.where(done, False, midp)

            # ---- idle: search for the sync word from ps
            live = (j >= ps) & ~keep
            nontr = torch.where(live & (diff == 0), j, -1)
            lprev = torch.cat([nontr.new_full((1,), -1),
                               torch.cummax(nontr, 0).values[:-1]])
            r = torch.where(lprev >= 0, j - lprev - 1, j - ps)
            mid = torch.where(lprev >= 0, r % 2 == 0, mp ^ (r % 2 == 1))
            proc = mid & (diff == 1) & live
            qi = torch.cumsum(proc, 0) - 1
            nproc = qi[-1] + 1
            pb = torch.cat([(sh >> (59 - torch.arange(60, device=dev))) & 1,
                            b.new_zeros(n + 1)])
            pb.index_copy_(0, torch.where(proc, 60 + qi, n + 60), b)
            where_q = j.new_zeros(n + 1).index_copy_(
                0, torch.where(proc, qi, n), j)
            win = pb[1:].unfold(0, 60, 1)                        # (n+1, 60)
            match = (win == sbits).all(1) & (
                torch.arange(n + 1, device=dev) < nproc)
            hit = match.any()
            qh = torch.argmax(match.to(torch.int8))
            h = where_q.index_select(0, qh.reshape(1))[0]
            last60 = (pb[nproc + torch.arange(60, device=dev)] * pow60).sum()
            y.index_copy_(0, torch.where(hit, off + torch.arange(
                6, device=dev), dump), syncw)
            off = off + torch.where(hit, 6, 0)
            mid_end = torch.where(ps <= n - 1, ~proc[-1], mp)
            searching = ~keep
            sh = torch.where(hit, _SYNC60,
                             torch.where(searching, last60, sh))
            word = torch.where(hit, 0, word)
            bitc = torch.where(hit, 10, bitc)
            wordc = torch.where(hit, _N_DATA, wordc)
            pos = torch.where(hit, h + 1, n)
            midp = torch.where(hit, False,
                               torch.where(keep, mid_kept, mid_end))
            synced = hit | keep
        new = dict(mid=midp, last=b[-1], synced=synced, sh=sh, word=word,
                   bitc=bitc, wordc=wordc)
        return new, (y[:dump].to(torch.int16), off.to(torch.int32))


class HrptDecoder(Block):
    """noaa_hrpt_decoder: minor-frame word sink with host-side telemetry
    parsing (noaa_hrpt_decoder.cc work/process_* — spacecraft address,
    minor-frame number + sequence errors, day-of-year, milliseconds).
    The device side is a pure capture; stats come from report(), which
    copies the capture to the host once."""

    def __init__(self, verbose: bool = False, output_files: bool = False,
                 name=None):
        self.in_ports = (Port(torch.int16),)
        self.out_ports = ()
        super().__init__(name)
        self.verbose = bool(verbose)
        self.output_files = bool(output_files)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    # Spacecraft-address table (noaa_hrpt_decoder.cc:32-49 hrpt_ids)
    HRPT_IDS = ("000000", "NOAA11", "000002", "NOAA16", "000004", "000005",
                "000006", "NOAA15", "000008", "NOAA12", "000010", "NOAA17",
                "000012", "NOAA18", "000014", "NOAA19")

    def report(self) -> dict:
        out = dict(frames_seen=0, seq_errs=0, address=None, spacecraft=None,
                   day_of_year=None, milliseconds=None, mfnums=[])
        if self.captured is None:
            return out
        words = self.captured[0]
        words = (words.cpu().numpy() if isinstance(words, torch.Tensor)
                 else np.asarray(words)).astype(np.int64) & 0x3FF
        nframes = len(words) // HRPT_MINOR_FRAME_WORDS
        expected = None
        for f in range(nframes):
            fr = words[f * HRPT_MINOR_FRAME_WORDS:
                       (f + 1) * HRPT_MINOR_FRAME_WORDS]
            mfnum = (fr[6] & 0x180) >> 7
            out["mfnums"].append(int(mfnum))
            if expected is not None and mfnum != expected:
                out["seq_errs"] += 1
            expected = mfnum % 3 + 1
            out["address"] = int((fr[6] & 0x078) >> 3)
            out["spacecraft"] = self.HRPT_IDS[out["address"]]
            out["day_of_year"] = int(fr[8] >> 1)
            out["milliseconds"] = int(((fr[9] & 0x7F) << 20)
                                      | (fr[10] << 10) | fr[11])
            out["frames_seen"] += 1
            if self.verbose:
                print(f"HRPT frame {f}: MF{mfnum} addr={out['address']} "
                      f"day={out['day_of_year']} ms={out['milliseconds']}")
        return out
