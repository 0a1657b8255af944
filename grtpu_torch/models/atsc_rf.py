"""ATSC 8-VSB RF front end: FPLL, bit timing, field sync, LMS equalizer.

Port of ``grtpu.models.atsc_rf`` (gr-atsc behaviour, re-designed for an
accelerator in grtpu, re-designed again here for the card):
  * GrAtscFPLL.cc — AGC + NCO mix + single-pole I/Q filters + atan2 phase
    detector (clamped to +-pi/2), 2nd-order loop alpha=1e-3, beta=alpha^2/4.
    ``fpll`` is the per-sample loop; ``fpll_chunked`` the closed form per
    256-sample chunk, each chunk one step replayed from a CUDA graph
    (:class:`grtpu_torch.runtime.step_graph.StepGraph`).  It repairs grtpu's
    tail: a call whose length is not a multiple of the chunk carries its
    state from its last valid sample, not from the zero pad.
  * atsci_sssr.cc — segment sync & symbol recovery, one step per 832-symbol
    segment (the per-symbol recurrence has a closed form within a
    segment), also replayed from a CUDA graph.  Its discrete choices (the
    interpolator phase and sample index of each symbol, the saturating
    integrator, lock and symbol index) are held to grtpu's: the prefix sum
    of the loop trajectory is summed in XLA's order
    (``grtpu_torch.digital.loops._cumsum``) and the 8-tap interpolation dot
    as XLA fuses it (:func:`_interp_dot`).
  * atsci_fs_correlator_naive.cc — field sync detection as one +-1
    correlation (the port's matmul FIR) over the whole stream.
  * atsci_equalizer_lms.cc / lms2 — per-field training on the known
    field-sync symbols (each sweep replayed from a CUDA graph), then the
    field filtered with the frozen taps: one FIR for the linear equalizer;
    for the decision-feedback one, one FIR for the feedforward part and the
    hand kernel ``dfe_feedback_fwd`` for the feedback recursion
    (:mod:`grtpu_torch.ops.cuda_trellis`).
  * GrAtscFieldSyncMux/Demux — field assembly on TX and disassembly on RX
    (host numpy, copies of grtpu's).

Entry points run on the card unless the caller passes ``device="cpu"``.
:func:`state_from_numpy` builds the carried states from grtpu's, and the
equalizers' :meth:`load` their taps, so a stream can resume in the port
where grtpu left it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from grtpu_torch.digital.loops import _cumsum
from grtpu_torch.ops import cuda_trellis, mmse_interp
from grtpu_torch.ops.dsp import linear_recurrence_const, single_pole_iir
from grtpu_torch.ops.fir import fir_filter
from grtpu_torch.runtime.step_graph import StepGraph
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import resolve

SEGMENT_LEN = 832                    # symbols, incl. 4 seg-sync symbols
DSEGS_PER_FIELD = 312
SYMBOLS_PER_FIELD = SEGMENT_LEN * (DSEGS_PER_FIELD + 1)


def _lfsr(nbits: int, taps, seed: int, n: int) -> np.ndarray:
    reg = [(seed >> i) & 1 for i in range(nbits)]
    out = np.empty(n, np.uint8)
    for k in range(n):
        out[k] = reg[nbits - 1]
        fb = 0
        for t in taps:
            fb ^= reg[t]
        reg = [fb] + reg[:-1]
    return out


ATSC_PN511 = _lfsr(9, (1, 2, 4, 5, 7, 8), 0b10, 511)
ATSC_PN63 = _lfsr(6, (4, 5), 0b111001, 63)

# 24 VSB-mode bits for 8-VSB (GrAtscFieldSyncMux.cc init_field_sync_common).
_VSB8_MODE = np.array([0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1,
                       1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 1], np.uint8)
SEG_SYNC_BITS = np.array([1, 0, 0, 1], np.uint8)


def field_sync_bits(field: int) -> np.ndarray:
    """The deterministic bit portion of a field sync segment (820 bits)."""
    mid = ATSC_PN63 ^ (1 if field else 0)
    return np.concatenate([SEG_SYNC_BITS, ATSC_PN511, ATSC_PN63, mid,
                           ATSC_PN63, _VSB8_MODE,
                           np.resize(ATSC_PN63, 92)])


def field_sync_codes(field: int, saved12: np.ndarray) -> np.ndarray:
    """Full 832-symbol field sync segment as 3-bit symbol codes (levels via
    2*code-7; binary symbols map to codes {1, 6} = levels -5/+5)."""
    bits = field_sync_bits(field)
    codes = np.where(bits, 6, 1).astype(np.uint8)
    return np.concatenate([codes, np.asarray(saved12, np.uint8)])


# The known +-5 training portion (equalizer): 4 + 511 + 189 symbols.
FS_TRAIN_LEN = 4 + 511 + 3 * 63


def fs_training_levels(field: int) -> np.ndarray:
    bits = field_sync_bits(field)[:FS_TRAIN_LEN]
    return (bits.astype(np.float32) * 10.0 - 5.0)


class AtscFieldSyncMux:
    """TX: (n, 828) data-segment symbol codes -> symbol code stream with
    segment syncs and field sync segments (GrAtscFieldSyncMux analog)."""

    def __init__(self):
        self.saved12 = np.zeros(12, np.uint8)
        self.segno = 0      # 0..311 within field
        self.field = 0

    def __call__(self, data_segments: np.ndarray) -> np.ndarray:
        out = []
        for seg in np.asarray(data_segments, np.uint8):
            if self.segno == 0:
                out.append(field_sync_codes(self.field, self.saved12))
            full = np.concatenate([np.where(SEG_SYNC_BITS, 6, 1
                                            ).astype(np.uint8), seg])
            out.append(full)
            self.saved12 = full[-12:]
            self.segno += 1
            if self.segno == DSEGS_PER_FIELD:
                self.segno = 0
                self.field ^= 1
        return np.concatenate(out) if out else np.zeros(0, np.uint8)


def vsb_modulate(baseband: np.ndarray, if_freq_norm: float,
                 samples_per_symbol: float,
                 vestige_frac: float = 0.0575) -> np.ndarray:
    """Real RRC-shaped baseband (pilot = DC offset) -> 8-VSB real passband.

    Applies the A/53 vestigial weighting in the frequency domain: full upper
    sideband, root-raised-cosine edge ramp through DC (the pilot) spanning
    +-vestige_frac * symbol_rate (0.0575 = alpha/2 for alpha=.115, i.e. the
    0.31 MHz vestige).  The ramp W(d) = sin(pi/4 (1 + d/v)) satisfies
    W^2(d) + W^2(-d) = 1, so after the receiver's matched RRC band edge the
    folded response is flat — this is what keeps both the FPLL pilot phase
    detector clean and the near-DC data undistorted.  The reference has no
    TX RF path (hardware does it); this utility exists for loopback testing
    of the RX chain.
    """
    x = np.asarray(baseband, np.float64)
    n = len(x)
    X = np.fft.fft(x)
    f = np.fft.fftfreq(n)                      # cycles/sample
    v = vestige_frac / samples_per_symbol      # vestige half-width
    u = np.clip(f / v, -1.0, 1.0)
    W = np.sin(np.pi / 4 * (1 + u))            # RRC edge: W(0)=sqrt(.5)
    a = np.fft.ifft(X * W * 2.0)               # analytic-ish VSB baseband
    return np.real(a * np.exp(2j * np.pi * if_freq_norm * np.arange(n))
                   ).astype(np.float32)


def state_from_numpy(cls, values, device=None):
    """A carried state of the port (``FpllState``, ``BtlState``) from
    grtpu's, given as numpy arrays: a mapping by field name, or a sequence
    in field order (``tuple(np.asarray(v) for v in grtpu_state)``)."""
    if isinstance(values, dict):
        values = [values[f] for f in cls._fields]
    dev = resolve(device)
    return cls(*(torch.from_numpy(np.array(v)).to(dev) for v in values))


# ---------------------------------------------------------------------------
# FPLL (GrAtscFPLL.cc)
# ---------------------------------------------------------------------------
FPLL_AGC_REFERENCE = 2.5 * 3.125     # fpll_btloop_coupling.h
FPLL_AGC_RATE = 0.25e-6
_FPLL_ALPHA = np.float32(1e-3)
_FPLL_BETA = np.float32(1e-3 ** 2 / 4)
_FPLL_LIMIT = np.float32(np.pi / 2)
_TWO_PI = np.float32(2 * np.pi)


class FpllState(NamedTuple):
    gain: torch.Tensor
    phase: torch.Tensor
    freq: torch.Tensor
    fi: torch.Tensor    # filtered I
    fq: torch.Tensor    # filtered Q


def fpll_init_state(initial_freq: float, fs: float, device=None) -> FpllState:
    dev = resolve(device)

    def f(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    return FpllState(gain=f(1e-3), phase=f(0.0),
                     freq=f(np.float32(2 * np.pi * initial_freq / fs)),
                     fi=f(0.0), fq=f(0.0))


def _iir_alpha(fs: float) -> np.float32:
    return np.float32(1 - np.exp(-1.0 / fs / 5e-6))


def fpll(state: FpllState, x: torch.Tensor, fs: float):
    """Real passband -> baseband I (pilot at DC), the per-sample loop (a
    Python loop of 0-d tensor ops; the receiver takes :func:`fpll_chunked`).
    Returns (state', I)."""
    a = _iir_alpha(fs)
    gain, phase, freq, fi, fq = state
    out = torch.empty_like(x)
    for k in range(x.shape[0]):
        inp = x[k] * gain
        gain = gain + (FPLL_AGC_REFERENCE - torch.abs(inp)) * FPLL_AGC_RATE
        # wrap each step: unbounded phase loses float32 precision
        phase = torch.remainder(phase + freq, _TWO_PI)
        i_k, q_k = inp * torch.sin(phase), inp * torch.cos(phase)
        fi = fi + a * (i_k - fi)
        fq = fq + a * (q_k - fq)
        pd = torch.clamp(torch.atan2(fq, fi), -_FPLL_LIMIT, _FPLL_LIMIT)
        phase = phase + _FPLL_ALPHA * pd
        freq = freq + _FPLL_BETA * pd
        out[k] = i_k
    return FpllState(gain, phase, freq, fi, fq), out


def _fpll_chunk(st: torch.Tensor, seg: torch.Tensor, iir_alpha: np.float32,
                sweeps: int, last: int):
    """One chunk of :func:`fpll_chunked` from the packed state ``st`` (5,)
    = (gain, phase, freq, fi, fq): returns (the state after sample ``last``
    of the chunk, packed, and the chunk's I).  Every recurrence is causal,
    so the state at ``last`` does not depend on the samples after it."""
    gain, phase, freq = st[0], st[1], st[2]
    # --- AGC closed form (gain BEFORE update scales each sample) ---
    A = 1.0 - FPLL_AGC_RATE * torch.abs(seg)
    P = torch.cumprod(A, 0)
    S = torch.cumsum((FPLL_AGC_RATE * FPLL_AGC_REFERENCE)
                     / torch.clamp_min(P, 1e-30), 0)
    g_after = P * (gain + S)
    inp = seg * torch.cat([gain[None], g_after[:-1]])
    # --- PLL fixed point ---
    pd = torch.zeros_like(seg)
    for _ in range(sweeps):
        freq_traj = freq + _FPLL_BETA * torch.cumsum(pd, 0)
        # phase used at step t: prev phase + prev freq (+ alpha*pd)
        dphi = freq_traj + _FPLL_ALPHA * pd
        ph = phase + freq + torch.cat([seg.new_zeros(1),
                                       torch.cumsum(dphi, 0)[:-1]])
        ph = torch.remainder(ph, _TWO_PI)
        iq = inp * torch.stack([torch.sin(ph), torch.cos(ph)])
        f, _ = linear_recurrence_const(float(1.0 - iir_alpha), iir_alpha * iq,
                                       st[3:5])
        pd = torch.clamp(torch.atan2(f[1], f[0]), -_FPLL_LIMIT, _FPLL_LIMIT)
    new = torch.stack([
        g_after[last], torch.remainder(ph[last] + _FPLL_ALPHA * pd[last],
                                       _TWO_PI),
        freq_traj[last], f[0, last], f[1, last]])
    return new, iq[0]


def fpll_chunked(state: FpllState, x: torch.Tensor, fs: float,
                 chunk: int = 256, sweeps: int = 2):
    """Chunk-batched FPLL with fpll()'s loop semantics.

    Per chunk: the AGC gain recurrence g' = g(1 - RATE|x|) + RATE*REF is
    linear with KNOWN coefficients -> exact cumprod/cumsum closed form;
    the PLL trajectory is solved by fixed point — predict the phase ramp
    with frozen freq, batch-compute the filtered I/Q phase detector, and
    re-solve freq/phase from the error batch in cumsum form (``sweeps``
    passes; the loop gains alpha=1e-3, beta=2.5e-7 are tiny, so the
    frozen-ramp error is far inside the detector's pull range).

    Each full chunk is one :class:`StepGraph` step (one CUDA-graph replay on
    the card).  A last, shorter chunk runs zero-padded and carries the state
    from its last valid sample (grtpu carries it from the end of the pad, so
    a streamed call whose length is not a multiple of ``chunk`` jumps in
    phase on the next call).  Returns (state', I)."""
    iir_alpha = _iir_alpha(fs)
    n = x.shape[0]
    nfull, tail = divmod(n, chunk)
    st = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(x.device)
                      for v in state])
    out = torch.empty((nfull + (tail > 0), chunk), dtype=torch.float32,
                      device=x.device)
    if nfull:
        xs = x[:nfull * chunk].reshape(nfull, chunk)
        ctr = torch.zeros(1, dtype=torch.int64, device=x.device)

        def step():
            seg = xs.index_select(0, ctr)[0]
            new, i_seg = _fpll_chunk(st, seg, iir_alpha, sweeps, chunk - 1)
            out.index_copy_(0, ctr, i_seg[None])
            st.copy_(new)
            ctr.add_(1)

        graph = StepGraph(step, x.device)
        for _ in range(nfull):
            graph()
    if tail:
        seg = torch.cat([x[nfull * chunk:], x.new_zeros(chunk - tail)])
        new, i_seg = _fpll_chunk(st, seg, iir_alpha, sweeps, tail - 1)
        out[nfull] = i_seg
        st = new
    return FpllState(*st.unbind()), out.reshape(-1)[:n]


def remove_dc(x: torch.Tensor, dc0, alpha: float = 1e-5):
    """Pilot removal: y = x - single_pole_iir(x) (fpll.py chain)."""
    y, dc = single_pole_iir(x, dc0, np.float32(alpha))
    return x - y, dc


# ---------------------------------------------------------------------------
# Bit timing loop (atsci_sssr.cc + atsci_interpolator), segment-batched.
# ---------------------------------------------------------------------------
LOOP_FILTER_TAP = 0.00025
ADJUSTMENT_GAIN = 1.0e-5 / (10 * SEGMENT_LEN) * 10e3
SSI_MIN, SSI_MAX = -16, 15
MIN_SEG_LOCK_CORRELATION_VALUE = 5
SYMBOL_INDEX_OFFSET = 3
_MMSE_TABLE = mmse_interp.mmse_taps().astype(np.float32)   # (129, 8)
_NTAPS_INTERP = _MMSE_TABLE.shape[1]
_DECAY = np.float32(1.0 - LOOP_FILTER_TAP)
_GAIN = np.float32(ADJUSTMENT_GAIN)


class BtlState(NamedTuple):
    mu: torch.Tensor          # fractional interpolator phase
    w: torch.Tensor           # samples per symbol estimate
    loop: torch.Tensor        # single-pole loop filter state
    timing_adjust: torch.Tensor
    integrator: torch.Tensor  # (832,) saturating seg-sync integrator
    seg_locked: torch.Tensor
    symbol_index: torch.Tensor
    corr_sr: torch.Tensor     # 4-bit 1001 correlator shift register
    quad_delay: torch.Tensor  # (4,) quad filter delay line


def btl_init_state(ratio: float, device=None) -> BtlState:
    dev = resolve(device)

    def f(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    return BtlState(mu=f(0.5), w=f(np.float32(ratio)), loop=f(0.0),
                    timing_adjust=f(0.0),
                    integrator=torch.full((SEGMENT_LEN,), SSI_MIN,
                                          dtype=torch.int32, device=dev),
                    seg_locked=torch.zeros((), dtype=torch.bool, device=dev),
                    symbol_index=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                    corr_sr=torch.zeros((), dtype=torch.int32, device=dev),
                    quad_delay=torch.zeros(4, dtype=torch.float32,
                                           device=dev))


def _fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding (the product exact in float64),
    as XLA's CPU backend contracts a multiply feeding an add."""
    return (a.double() * b.double() + c.double()).float()


def _interp_dot(taps: torch.Tensor, wins: torch.Tensor) -> torch.Tensor:
    """sum_k taps[:, k] * wins[:, k] over the 8 taps as XLA sums the
    reduce of a product on a CPU: in order, each product fused into the
    running float32 sum."""
    acc = (taps[:, 0] * wins[:, 0])
    for k in range(1, _NTAPS_INTERP):
        acc = _fma(taps[:, k], wins[:, k], acc)
    return acc


def _btl_consts(device):
    """j = 1..831, (1-tap)^j, (1-tap)^832 and the adjustment gain as
    float32 tensors on ``device``, made once per device (a captured step
    makes no tensor from host data)."""
    return _btl_consts_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def _btl_consts_on(device: torch.device):
    j = np.arange(1, SEGMENT_LEN, dtype=np.float32)
    return tuple(torch.from_numpy(np.asarray(v, np.float32)).to(device)
                 for v in (j, _DECAY ** j, _DECAY ** SEGMENT_LEN, _GAIN))


def _btl_segment(st: BtlState, window: torch.Tensor):
    """Process one 832-symbol segment from `window` (samples starting at the
    current interpolator base).  Returns new state, symbols (832,),
    consumed, locked, symbol_index.

    The reference updates (mu, w, loop) per symbol, but timing_adjust is
    constant between 832-symbol wraps, so the recurrence is closed-form:
      loop_j = ta + (loop_0 - ta) * (1-tap)^j          (j updates applied)
      pos_j  = pos_0 + j*w + GAIN * sum_{i<=j} loop_i
    """
    n = SEGMENT_LEN
    dev = window.device
    ta = st.timing_adjust
    j, pw, decay_n, gain = _btl_consts(dev)
    loop_traj = _fma(st.loop - ta, pw, ta)                # loop after j updates
    # positions: symbol 0 interpolates at mu (before any update); symbol k
    # at mu + k*w + GAIN * (loop_1 + .. + loop_k)
    csum = _cumsum(loop_traj)
    pos = torch.cat([j.new_zeros(1), _fma(j, st.w, _GAIN * csum)]) + st.mu
    base = torch.floor(pos)
    mu_frac = pos - base
    idx = base.to(torch.int64)

    # batched 8-tap MMSE interpolation: windows (832, 8) x phase taps
    phase = torch.round(mu_frac * mmse_interp.NSTEPS).to(torch.int64)
    taps = mmse_interp.bank_on(dev)[phase]                # (832, 8)
    wins = window[idx[:, None] + torch.arange(_NTAPS_INTERP, device=dev)]
    symbols = _interp_dot(taps, wins)

    # --- sssr segment update, vectorized over the 832 symbols ---
    # quad filter y[k] = x[k-3] + x[k-2] - x[k-1] - x[k]; delay line holds
    # [d0..d3] = [x[-1], x[-2], x[-3], x[-4]]
    xq = torch.cat([torch.flip(st.quad_delay, (0,)), symbols])
    quad = xq[1:n + 1] + xq[2:n + 2] - xq[3:n + 3] - xq[4:n + 4]
    # digital correlator: 1001 on sign bits; shift register carries the
    # previous segment's last bits (sr bit3 = b[-1], bit2 = b[-2], ...)
    bits = (symbols >= 0).to(torch.int32)
    sr = st.corr_sr
    sr_bits = torch.cat([torch.stack([(sr >> 1) & 1, (sr >> 2) & 1,
                                      (sr >> 3) & 1]), bits])
    corr = ((sr_bits[3:] == 1) & (sr_bits[2:-1] == 0)
            & (sr_bits[1:-2] == 0) & (sr_bits[:-3] == 1))
    weight = torch.where(corr, 2, -1).to(torch.int32)
    integ = torch.clamp(st.integrator + weight, SSI_MIN, SSI_MAX)

    best = torch.argmax(integ).reshape(1)     # first index, as jnp.argmax
    locked = integ.index_select(0, best)[0] >= MIN_SEG_LOCK_CORRELATION_VALUE
    new_ta = quad.index_select(0, best)[0]
    best = best[0]
    symbol_index = torch.remainder(SYMBOL_INDEX_OFFSET - 1 - best,
                                   SEGMENT_LEN).to(torch.int32)

    # state after 832 (mu, w, loop) updates
    new_loop = _fma(st.loop - ta, decay_n, ta)
    end_pos = _fma(gain, new_loop, pos[-1] + st.w)
    consumed = torch.floor(end_pos)
    new_mu = end_pos - consumed

    new_st = BtlState(
        mu=new_mu, w=st.w, loop=new_loop, timing_adjust=new_ta,
        integrator=integ, seg_locked=locked, symbol_index=symbol_index,
        corr_sr=(bits[-1] << 3) | (bits[-2] << 2) | (bits[-3] << 1)
        | bits[-4],
        quad_delay=torch.flip(symbols[-4:], (0,)))
    return new_st, symbols, consumed.to(torch.int64), locked, symbol_index


# window large enough for one segment at ratio <= 2.75 plus interp taps
BTL_WINDOW = 2336


def bit_timing_loop(state: BtlState, samples: torch.Tensor, nsegments: int):
    """Recover `nsegments` x 832 symbols from `samples`.

    Returns (state', symbols (nsegments*832,), first_symbol_offset, locked,
    sync_index, consumed_total).  `first_symbol_offset[s]` is the stream
    position (mod 832) of segment s's first output symbol relative to true
    segment-sync boundaries, valid once `locked[s]` is True.  Caller must
    supply len(samples) >= nsegments * ratio * 832 + BTL_WINDOW.

    One segment is one :class:`StepGraph` step (one CUDA-graph replay on
    the card): the window is gathered at a base index kept on the device,
    clamped into the stream as ``lax.dynamic_slice`` clamps it."""
    dev = samples.device
    st = BtlState(*(torch.as_tensor(v).to(dev).clone() for v in state))
    base = torch.zeros((), dtype=torch.int64, device=dev)
    sym = torch.empty((nsegments, SEGMENT_LEN), dtype=torch.float32,
                      device=dev)
    info = torch.empty((nsegments, 3), dtype=torch.int32, device=dev)
    if nsegments:
        samples = samples.to(torch.float32)
        span = torch.arange(BTL_WINDOW, device=dev)
        ctr = torch.zeros(1, dtype=torch.int64, device=dev)
        last_start = samples.shape[0] - BTL_WINDOW

        def step():
            start = torch.clamp(base, 0, last_start)
            new, symbols, consumed, locked, sync = _btl_segment(
                st, samples[start + span])
            # the segment just emitted started at symbol_index + 1 (the
            # reference increments before the wrap check)
            first = torch.remainder(st.symbol_index + 1, SEGMENT_LEN)
            sym.index_copy_(0, ctr, symbols[None])
            info.index_copy_(0, ctr, torch.stack(
                [first.to(torch.int32), locked.to(torch.int32), sync])[None])
            for buf, v in zip(st, new):
                buf.copy_(v)
            base.add_(consumed)
            ctr.add_(1)

        graph = StepGraph(step, dev)
        for _ in range(nsegments):
            graph()
    return (st, sym.reshape(-1), info[:, 0], info[:, 1].bool(), info[:, 2],
            base.to(torch.int32))


# ---------------------------------------------------------------------------
# Field sync correlator (atsci_fs_correlator_naive.cc), vectorized.
# ---------------------------------------------------------------------------
PN511_ERROR_LIMIT = 20
PN63_ERROR_LIMIT = 5
_FS_PATTERN = np.concatenate([SEG_SYNC_BITS, ATSC_PN511]).astype(np.float32)
_PN63_OFFSET = 4 + 511 + 63          # start of the middle PN63


def fs_correlate(symbols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find field sync starts in a symbol stream.

    Returns (tag, field) tensors of len(symbols): tag[p] True when a field
    sync segment starts at p; field[p] in {0,1} classifies it.  The +-1
    correlations are sums of at most 515 +-1 terms, exact in float32 in any
    order.
    """
    n = symbols.shape[0]
    bits_pm = torch.where(symbols >= 0, 1.0, -1.0).to(torch.float32)
    pat = (_FS_PATTERN * 2 - 1).astype(np.float32)
    L = len(pat)
    xp = torch.cat([bits_pm, bits_pm.new_zeros(L - 1)])
    m = fir_filter(xp, pat[::-1].copy(), 1)[:n]
    errors_511 = (L - m) / 2
    hit = errors_511 < PN511_ERROR_LIMIT

    pat63 = (ATSC_PN63.astype(np.float32) * 2 - 1)
    xp63 = torch.cat([bits_pm, bits_pm.new_zeros(62)])
    m63 = fir_filter(xp63, pat63[::-1].copy(), 1)[:n]
    err63 = (63 - m63) / 2
    # err63 at position p+_PN63_OFFSET classifies field at start p
    err63_at = torch.cat([err63[_PN63_OFFSET:],
                          err63.new_full((_PN63_OFFSET,), 31.0)])[:n]
    field1 = err63_at <= PN63_ERROR_LIMIT
    field2 = err63_at >= 63 - PN63_ERROR_LIMIT
    tag = hit & (field1 | field2)
    return tag, field2.to(torch.int32)


# ---------------------------------------------------------------------------
# LMS equalizer (atsci_equalizer_lms.cc), train-per-field + one FIR.
# ---------------------------------------------------------------------------
EQ_NTAPS = 256
EQ_NPRETAPS = int(EQ_NTAPS * 0.8)
EQ_CURSOR = EQ_NTAPS - EQ_NPRETAPS - 1      # 51: y[k] uses x[k-51 .. k+204]
EQ_BETA = 0.00005
_LMS_MU = np.float32(0.25)


def _windows(x: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """(n, width): row k is x[k : k + width]."""
    return x.unfold(0, width, 1)[:n]


def _lms_sweep(taps, wins, d, ys=None):
    """One NLMS sweep over the training windows, updating ``taps`` in
    place (the step of grtpu's scan); ``ys`` (if given) takes each step's
    output."""
    for k in range(wins.shape[0]):
        w = wins[k]
        y = torch.dot(taps, w)
        if ys is not None:
            ys[k] = y
        e = y - d[k]
        taps.sub_(_LMS_MU * e * w / (torch.dot(w, w) + 1e-3))


def _lms_train(taps, x_train, d_train):
    """NLMS adaptation over the field sync training window.

    x_train: (FS_TRAIN_LEN + EQ_NTAPS - 1,) input samples such that training
    symbol k sees window x_train[k : k + EQ_NTAPS]; d_train: known levels.
    The reference uses raw LMS (BETA 5e-5) and relies on a converged AGC
    plus many fields; normalizing the step by ||x||^2 makes convergence
    scale-free and fast enough to be useful from the first field.  Returns
    (taps', ys)."""
    taps = taps.clone()
    ys = torch.empty(FS_TRAIN_LEN, dtype=torch.float32, device=taps.device)
    _lms_sweep(taps, _windows(x_train, FS_TRAIN_LEN, EQ_NTAPS), d_train, ys)
    return taps, ys


def _eq_filter(taps, x):
    """Filter with frozen taps: y[k] = sum_i taps[i] x[k + i] over windows of
    x (caller supplies EQ_NTAPS-1 context): one FIR (the port's matmul)."""
    n = x.shape[0] - EQ_NTAPS + 1
    return fir_filter(x, torch.flip(taps, (0,)), 1)[:n]


def _field_type(x_field: np.ndarray) -> int:
    """Field 0 or 1 from the middle PN63's polarity (sign vote)."""
    mid = x_field[EQ_CURSOR + _PN63_OFFSET: EQ_CURSOR + _PN63_OFFSET + 63]
    votes = np.sum(np.sign(mid) == (ATSC_PN63.astype(np.float32) * 2 - 1))
    return 0 if votes >= 32 else 1


def _on(v, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)


class AtscEqualizerLms:
    """Per-field: adapt on the known field-sync symbols, then equalize the
    field's data with the frozen taps (one FIR).

    Differences from the reference (which leans on a converged AGC and many
    fields of adaptation), as in grtpu: on the first field the taps are
    initialized to a scale-matched delta at the cursor (the LS-optimal
    single tap), and each field runs `sweeps` LMS passes over the 704 known
    symbols instead of one.  Each sweep is one :class:`StepGraph` step."""

    def __init__(self, sweeps: int = 8, device=None):
        self.taps = None
        self.sweeps = sweeps
        self.device = resolve(device)
        self._train = None

    def load(self, taps):
        """Resume from grtpu's taps (numpy).  Taps already on the device
        are overwritten in place: the captured training sweep keeps their
        address."""
        taps = _on(taps, self.device)
        if self.taps is None:
            self.taps = taps.clone()
        else:
            self.taps.copy_(taps)

    def process_field(self, x_field):
        """x_field: symbols of one field starting at its field sync, with
        EQ_CURSOR samples of extra left context and EQ_NTAPS-EQ_CURSOR-1 of
        right context: len = SYMBOLS_PER_FIELD + EQ_NTAPS - 1.  Returns the
        equalized field (numpy)."""
        x_field = np.asarray(x_field, np.float32)
        d_np = fs_training_levels(_field_type(x_field))
        if self.taps is None:
            x_cur = x_field[EQ_CURSOR: EQ_CURSOR + FS_TRAIN_LEN]
            scale = float(np.dot(x_cur, d_np) / (np.dot(x_cur, x_cur) + 1e-9))
            taps = np.zeros(EQ_NTAPS, np.float32)
            taps[EQ_CURSOR] = scale
            self.load(taps)
        x = _on(x_field, self.device)
        self._adapt(x, d_np)
        return _eq_filter(self.taps, x).cpu().numpy()

    def _adapt(self, x, d_np):
        """The field's training sweeps, in place on ``taps``."""
        wins = _windows(x[: FS_TRAIN_LEN + EQ_NTAPS - 1], FS_TRAIN_LEN,
                        EQ_NTAPS)
        if self._train is None:
            self._wins = wins.clone()
            self._d = _on(d_np, self.device)
            self._train = StepGraph(
                lambda: _lms_sweep(self.taps, self._wins, self._d),
                self.device)
        else:
            self._wins.copy_(wins)
            self._d.copy_(_on(d_np, self.device))
        for _ in range(self.sweeps):
            self._train()


class AtscEqualizerNop:
    """Pass-through equalizer (atsci_equalizer_nop.cc:47-118: output =
    input, cursor-aligned) — the family's null member, the baseline that
    *shows* when an adaptive equalizer earns its keep."""

    def __init__(self, device=None):
        self.device = resolve(device)

    def process_field(self, x_field):
        x_field = np.asarray(x_field, np.float32)
        return x_field[EQ_CURSOR: EQ_CURSOR + SYMBOLS_PER_FIELD]


# --- decision-feedback equalizer (atsci_equalizer_lms2.cc:36-37,268-287:
# NFFTAPS=64 feedforward + NFBTAPS=192 feedback over sliced past outputs,
# trained on the 704 known field-sync symbols.  The reference ships with
# the feedback adaptation stubbed out ("kludge()" returns 0 at :283 — the
# fb taps never move); grtpu completes the design: both tap sets adapt,
# NLMS-normalized, and during training the feedback ring holds the KNOWN
# training levels (correct-decision assumption, standard DFE training). ---
DFE_NFF = 64
DFE_NFB = 192


def _dfe_windows(x_train, d_train):
    wins_x = _windows(x_train, FS_TRAIN_LEN, DFE_NFF)
    dpad = torch.cat([d_train.new_zeros(DFE_NFB), d_train])
    wins_d = torch.flip(_windows(dpad, FS_TRAIN_LEN, DFE_NFB), (1,))
    return wins_x, wins_d


def _dfe_sweep(wff, wfb, wins_x, wins_d, d, mu):
    """One NLMS sweep of the DFE at step size ``mu`` (a 0-d tensor),
    updating both tap sets in place (the step of grtpu's scan).  The first
    NFB training symbols' "past decisions" are the previous field's unknown
    data, not the zeros of the ring: only the steps from NFB on adapt."""
    for k in range(DFE_NFB, wins_x.shape[0]):
        xw, dw = wins_x[k], wins_d[k]
        y = torch.dot(wff, xw) - torch.dot(wfb, dw)
        e = y - d[k]
        nrm = torch.dot(xw, xw) + torch.dot(dw, dw) + 1e-3
        wff.sub_(mu * e * xw / nrm)
        wfb.add_(mu * e * dw / nrm)


def _dfe_train(wff, wfb, x_train, d_train, mu):
    """One NLMS sweep over the training window at step size ``mu``.

    x_train: (FS_TRAIN_LEN + DFE_NFF - 1,) such that training symbol k sees
    the forward window x_train[k : k + DFE_NFF]; d_train: known levels.
    wfb[i] multiplies decision d[k-1-i] (past decisions, newest first).
    Callers gear-shift mu downward across sweeps (the reference's own
    "FIXME add gear-shifting", atsci_equalizer_lms2.cc:271).  Returns
    (wff', wfb')."""
    wff, wfb = wff.clone(), wfb.clone()
    wins_x, wins_d = _dfe_windows(x_train, d_train)
    mu = torch.as_tensor(mu, dtype=torch.float32).to(wff.device)
    _dfe_sweep(wff, wfb, wins_x, wins_d, d_train, mu)
    return wff, wfb


def _dfe_filter(wff, wfb, x_ff, d_init):
    """Decision-feedback filtering: the feedforward part is ONE dense FIR
    over the whole field (the port's matmul); only the inherently
    sequential feedback — a 192-tap dot against the carried ring of sliced
    past decisions — runs as a recursion: the hand kernel
    ``dfe_feedback_fwd`` on the card, its plain twin on a CPU."""
    ff = fir_filter(x_ff, torch.flip(wff, (0,)), 1)
    y, _ = cuda_trellis.dfe_feedback(ff, wfb, d_init)
    return y


class AtscEqualizerDfe:
    """Per-field decision-feedback equalizer (the lms2 family member):
    adapt FF+FB taps on the known field-sync symbols (``sweeps`` NLMS
    passes, each one :class:`StepGraph` step), then equalize the field's
    data with frozen taps and live decision feedback.  Consumes the same
    (SYMBOLS_PER_FIELD + EQ_NTAPS - 1)-sample window as AtscEqualizerLms:
    the forward window of symbol k is x_field[k + EQ_CURSOR : k + EQ_CURSOR
    + DFE_NFF] (cursor at the first FF tap; post-cursor ISI is the feedback
    taps' job)."""

    def __init__(self, sweeps: int = 8, device=None):
        self.wff = None
        self.wfb = None
        self.sweeps = sweeps
        self.device = resolve(device)
        self._train = None

    def load(self, wff, wfb):
        """Resume from grtpu's taps (numpy).  Taps already on the device
        are overwritten in place: the captured training sweep keeps their
        address."""
        wff, wfb = _on(wff, self.device), _on(wfb, self.device)
        if self.wff is None:
            self.wff, self.wfb = wff.clone(), wfb.clone()
        else:
            self.wff.copy_(wff)
            self.wfb.copy_(wfb)

    def process_field(self, x_field):
        x_field = np.asarray(x_field, np.float32)
        d_np = fs_training_levels(_field_type(x_field))
        if self.wff is None:
            x_cur = x_field[EQ_CURSOR: EQ_CURSOR + FS_TRAIN_LEN]
            scale = float(np.dot(x_cur, d_np) / (np.dot(x_cur, x_cur) + 1e-9))
            wff = np.zeros(DFE_NFF, np.float32)
            wff[0] = scale                       # cursor = first FF tap
            self.load(wff, np.zeros(DFE_NFB, np.float32))
        x = _on(x_field[EQ_CURSOR:], self.device)
        self._adapt(x, _on(d_np, self.device))
        # field data: the recursion starts at the field sync itself, so the
        # decision ring warms up over the full 832-symbol sync segment
        # before the first data segment — the zero init only touches
        # equalized output nobody demuxes
        ring = torch.zeros(DFE_NFB, dtype=torch.float32, device=self.device)
        y = _dfe_filter(self.wff, self.wfb,
                        x[: SYMBOLS_PER_FIELD + DFE_NFF - 1], ring)
        return y.cpu().numpy()

    def _adapt(self, x, d):
        """The field's gear-shifted training sweeps, in place on ``wff``
        and ``wfb``."""
        wins_x, wins_d = _dfe_windows(x[: FS_TRAIN_LEN + DFE_NFF - 1], d)
        if self._train is None:
            self._wins_x, self._wins_d = wins_x.clone(), wins_d.clone()
            self._d = d.clone()
            self._mu = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            self._train = StepGraph(
                lambda: _dfe_sweep(self.wff, self.wfb, self._wins_x,
                                   self._wins_d, self._d, self._mu),
                self.device)
        else:
            self._wins_x.copy_(wins_x)
            self._wins_d.copy_(wins_d)
            self._d.copy_(d)
        for s in range(self.sweeps):
            # gear shift: halve mu each sweep after the first half
            self._mu.fill_(0.25 * (0.5 ** max(0, s - self.sweeps // 2)))
            self._train()


EQUALIZERS = {"nlms": AtscEqualizerLms, "lms2": AtscEqualizerDfe,
              "dfe": AtscEqualizerDfe, "nop": AtscEqualizerNop}


# ---------------------------------------------------------------------------
# Field sync demux (GrAtscFieldSyncDemux analog) + full RF receiver.
# ---------------------------------------------------------------------------
def fs_demux(symbols: np.ndarray, fs_positions: np.ndarray) -> np.ndarray:
    """Extract data-segment symbols for each complete field whose field sync
    starts at p: 312 segments of 828 (segment syncs stripped)."""
    fields = []
    for p in fs_positions:
        start = p + SEGMENT_LEN
        end = p + SYMBOLS_PER_FIELD
        if end > len(symbols):
            break
        segs = symbols[start:end].reshape(DSEGS_PER_FIELD, SEGMENT_LEN)
        fields.append(segs[:, 4:])
    return (np.stack(fields) if fields
            else np.zeros((0, DSEGS_PER_FIELD, SEGMENT_LEN - 4)))


class AtscRfReceiver:
    """Full RF chain: FPLL -> LPF -> DC removal -> bit timing -> field sync
    -> equalizer -> demux, on ``device`` (the card unless named).  Produces
    per-field (312, 828) soft symbols (numpy) ready for the transport
    decoder (grtpu_torch.models.atsc.AtscReceiver).

    A call reads the card 3 + F times (F = fields equalized): the symbols,
    the lock flags, the field-sync tags, and each equalized field; as in
    grtpu, each field goes back to the card from the host symbols."""

    def __init__(self, fs: float, if_freq: float,
                 ratio: float | None = None, equalizer: str = "nlms",
                 chunked_fpll: bool = True, device=None):
        self.fs = fs
        self.if_freq = if_freq
        self.device = resolve(device)
        # chunk-batched FPLL by default (fpll_chunked: same loop in
        # closed form per 256-sample chunk); chunked_fpll=False keeps
        # the per-sample loop
        self.chunked_fpll = bool(chunked_fpll)
        self.ratio = ratio if ratio is not None else fs / 10.76e6
        self.fpll_state = fpll_init_state(if_freq, fs, self.device)
        self.btl_state = btl_init_state(self.ratio, self.device)
        # selectable family, as the reference's -e flag chooses among
        # atsci_equalizer_{nop,lms,lms2} (atsc_rx.py / GrAtscEqualizer)
        self.eq = EQUALIZERS[equalizer](device=self.device)
        # Matched RRC as a passband filter BEFORE the FPLL (fpll.py: a half
        # symbol-rate lowpass RRC heterodyned up to the band center): the
        # band-edge shaping suppresses the data power around the pilot so
        # the FPLL's atan2 detector sees a clean pilot.
        sym_rate = fs / self.ratio
        ntaps = 279
        lp = firdes.root_raised_cosine(1.0, fs, sym_rate / 2, 0.115, ntaps)
        i = np.arange(ntaps)
        # band center = pilot + symbol_rate/4 (atsc_fpll.cc:59)
        arg = 2 * np.pi * (if_freq + sym_rate / 4) / fs
        self.pb_rrc = (lp * 2 * np.cos(arg * i)).astype(np.float32)
        # post-FPLL low pass (fpll.py chain): pass the VSB baseband
        # (1.115/(2*ratio) of fs single-sided), stop the 2*IF mixing image
        bw = 0.5 * 1.115 / self.ratio
        self.lpf = firdes.low_pass(1.0, fs, (bw + 0.04) * fs, 0.05 * fs)
        self.dc = torch.zeros((), dtype=torch.float32, device=self.device)

    def process(self, samples) -> np.ndarray:
        """Returns the equalized fields (numpy).  The call keeps the
        recovered symbols (``symbols``, numpy) and the field-sync positions
        it equalized (``field_starts``)."""
        x = torch.as_tensor(np.asarray(samples, np.float32)).to(self.device)
        pbf = self._passband(x)
        if self.chunked_fpll:
            self.fpll_state, bb = fpll_chunked(self.fpll_state, pbf, self.fs)
        else:
            self.fpll_state, bb = fpll(self.fpll_state, pbf, self.fs)
        bbd = self._baseband(bb)
        nseg = int((len(samples) - BTL_WINDOW) // (self.ratio * SEGMENT_LEN))
        (self.btl_state, sym_d, _, locked_d, _, _) = bit_timing_loop(
            self.btl_state, bbd, nseg)
        tag_d, _ = fs_correlate(sym_d)
        sym = self.symbols = sym_d.cpu().numpy()
        locked = locked_d.cpu().numpy()
        self.field_starts = []
        fs_pos = np.nonzero(tag_d.cpu().numpy())[0]
        # Skip field syncs detected during acquisition: the FPLL/AGC pull-in
        # garbles early symbols even though the (sign-based) sync pattern can
        # still match, and an equalizer trained there diverges.  Require the
        # bit timing loop to have been seg-locked for a few segments.
        if not locked.any():
            return np.zeros((0, DSEGS_PER_FIELD, SEGMENT_LEN - 4))
        min_pos = max((int(np.argmax(locked)) + 4) * SEGMENT_LEN,
                      int(self.fs * 0.004 / self.ratio))  # ~4ms FPLL settle
        out_fields = []
        for p in fs_pos:
            if p < max(min_pos, EQ_CURSOR):
                continue
            if p + SYMBOLS_PER_FIELD + EQ_NTAPS > len(sym):
                break
            xf = sym[p - EQ_CURSOR:
                     p - EQ_CURSOR + SYMBOLS_PER_FIELD + EQ_NTAPS - 1]
            eq_out = self.eq.process_field(xf)
            self.field_starts.append(int(p))
            out_fields.append(fs_demux(eq_out, np.array([0]))[0])
        return (np.stack(out_fields) if out_fields
                else np.zeros((0, DSEGS_PER_FIELD, SEGMENT_LEN - 4)))

    def _passband(self, x):
        """The passband RRC ahead of the FPLL."""
        kp = len(self.pb_rrc)
        return fir_filter(torch.cat([x.new_zeros(kp - 1), x]), self.pb_rrc, 1)

    def _baseband(self, bb):
        """The post-FPLL low pass, then the DC removal (its state carried)."""
        k = len(self.lpf)
        bbf = fir_filter(torch.cat([bb.new_zeros(k - 1), bb]), self.lpf, 1)
        bbd, self.dc = remove_dc(bbf, self.dc)
        return bbd
