"""Polyphase filterbank blocks + PFB clock sync (port of
``grtpu.blocks.pfb``).

Analogs: gr_pfb_channelizer_ccf, gr_pfb_synthesis_filterbank_ccf,
gr_pfb_arb_resampler_{ccf,fff}, gr_pfb_decimator_ccf, gr_pfb_interpolator_ccf,
gr_pfb_clock_sync_{ccf,fff}, and the blks2impl wrappers
(pfb_channelizer.py, pfb_arb_resampler.py, ...).

The clock sync is a per-symbol recursion.  Like the M&M loops of
:mod:`grtpu_torch.digital.loops` it runs as a Python loop over 0-d tensors
on the stream's device: windows and bank rows are picked by device-side
indices (grtpu's one-hot selects pick the same values), no step reads a
value back to the host, and the matched-filter dots are summed in grtpu's
order so both packages round to the same filter index.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.blocks.filter import _TapsOnDevice
from grtpu_torch.digital.loops import (_bf16, _cumsum, _f32, _window_rows,
                                       rationalize_sps)
from grtpu_torch.ops import dsp
from grtpu_torch.ops import pfb as pfb_ops
from grtpu_torch.ops.fir import interp_fir_filter
from grtpu_torch.ops.mmse_interp import scan_dot
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import resolve


class PfbChannelizer(Block):
    """gr_pfb_channelizer_ccf: stream in -> (nchan,)-vector stream out at
    rate oversample*fs/nchan.  Channel c centered at +c*fs/nchan."""

    def __init__(self, nchan: int, taps=None, oversample: int = 1,
                 taps_per_branch: int = 12, precision: str = "f32",
                 name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64, nchan),)
        if taps is None:
            taps = pfb_ops.design_channelizer_taps(nchan, taps_per_branch)
        self.taps = np.asarray(taps, np.float32)
        kp = -(-len(self.taps) // nchan)
        self.decim = nchan // oversample
        self.history = kp * nchan + 1
        super().__init__(name)
        self.nchan = nchan
        self.oversample = oversample
        self.precision = precision  # "f32" exact / "bf16x3" / "bf16"

    def apply(self, state, x):
        # history = kp*nchan + 1 => executor delivers exactly kp*nchan
        # context samples, the channelizer's required history
        return state, pfb_ops.channelize(x, self.taps, self.nchan,
                                         self.oversample,
                                         precision=self.precision)


class PfbSynthesizer(Block):
    """gr_pfb_synthesis_filterbank_ccf: (nchan,)-vector stream -> stream."""

    def __init__(self, nchan: int, taps=None, taps_per_branch: int = 12,
                 name=None):
        self.in_ports = (Port(torch.complex64, nchan),)
        self.out_ports = (Port(torch.complex64),)
        if taps is None:
            taps = pfb_ops.design_channelizer_taps(nchan, taps_per_branch)
        self.taps = np.asarray(taps, np.float32)
        kp = -(-len(self.taps) // nchan)
        self.interp = nchan
        self.history = kp
        super().__init__(name)
        self.nchan = nchan

    def apply(self, state, x):
        return state, pfb_ops.synthesize(x, self.taps)


class PfbArbResampler(Block):
    """gr_pfb_arb_resampler_{ccf,fff}: rational-approximated arbitrary rate.

    rate is snapped to a Fraction (denominator <= 4096); the executor's
    chunking stays static and sample-exact at that rational rate.
    """

    def __init__(self, rate: float, taps=None, filter_size: int = 32,
                 dtype=torch.complex64, name=None):
        fr = Fraction(rate).limit_denominator(4096)
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.interp = fr.numerator
        self.decim = fr.denominator
        if taps is None:
            taps = pfb_ops.design_arb_resampler_taps(float(fr), filter_size)
        self.taps = np.asarray(taps, np.float32)
        self.filter_size = filter_size
        kp = -(-len(self.taps) // filter_size)
        self.history = kp
        super().__init__(name)
        self.rate = fr

    def apply(self, state, x):
        return state, pfb_ops.arb_resample(x, self.taps, self.rate,
                                           self.filter_size)


class PfbDecimator(Block):
    """gr_pfb_decimator_ccf: channelizer collapsed to one selected channel
    (band-select decimation by nchan)."""

    def __init__(self, nchan: int, channel: int = 0, taps=None,
                 taps_per_branch: int = 12, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        if taps is None:
            taps = pfb_ops.design_channelizer_taps(nchan, taps_per_branch)
        self.taps = np.asarray(taps, np.float32)
        kp = -(-len(self.taps) // nchan)
        self.decim = nchan
        self.history = kp * nchan + 1
        super().__init__(name)
        self.nchan = nchan
        self.channel = channel

    def apply(self, state, x):
        y = pfb_ops.channelize(x, self.taps, self.nchan, 1)
        return state, y[:, self.channel]


class PfbInterpolator(_TapsOnDevice, Block):
    """gr_pfb_interpolator_ccf: polyphase interpolation by L."""

    def __init__(self, interp: int, taps=None, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.interp = interp
        if taps is None:
            taps = firdes.low_pass(interp, interp, 0.45, 0.1)
        self.taps = np.asarray(taps, np.float32)
        self.history = -(-len(self.taps) // interp)
        super().__init__(name)

    def apply(self, state, x):
        return state, interp_fir_filter(x, self._taps_on(x.device),
                                        self.interp)


# --------------------------------------------------------------- clock sync
@functools.lru_cache(maxsize=16)
def _sync_banks(taps_bytes: bytes, taps_dtype: str, nfilts: int,
                device: torch.device):
    """(bank, dbank) on ``device``: the prototype and its first difference,
    each split into nfilts phases in convolution orientation, (nfilts, kp)."""
    proto = np.frombuffer(taps_bytes, dtype=taps_dtype)
    bank = pfb_ops.polyphase_taps(proto, nfilts)[:, ::-1].copy()
    dbank = pfb_ops.polyphase_taps(pfb_ops._derivative_taps(proto),
                                   nfilts)[:, ::-1].copy()
    return (torch.from_numpy(bank).to(device=device, dtype=torch.float32),
            torch.from_numpy(dbank).to(device=device, dtype=torch.float32))


def _banks_on(taps, nfilts: int, device):
    proto = np.ascontiguousarray(taps)
    return _sync_banks(proto.tobytes(), proto.dtype.str, nfilts,
                       torch.device(device))


def _timing_error(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Re(dout * conj(out)) clipped to [-1, 1] (the reference's error)."""
    if out.is_complex():
        e = dout.real * out.real + dout.imag * out.imag
    else:
        e = dout * out
    return torch.clamp(e, -1.0, 1.0)


def pfb_clock_sync(x: torch.Tensor, state, sps: float, taps: np.ndarray,
                   nfilts: int, loop_bw: float, max_dev: float = 1.5,
                   gains=None, with_diag: bool = False):
    """gr_pfb_clock_sync_ccf: timing recovery selecting among nfilts
    phase-shifted matched filters, 2nd-order loop on (d_k, d_rate).

    The matched-filter bank is the prototype split into nfilts phases; the
    timing error is Re(out_deriv * conj(out)) (the reference's error), fed
    to a proportional-plus-integrator loop on the filter index.

    x: samples with kp-1+ceil(sps) lookahead/history slack.
    state: (k, rate_f, base) — filter phase, rate deviation, sample pointer
    (0-d float32 tensors on x's device).
    Returns (y_padded, n_valid, state'); n_valid is a 0-d int32 tensor.
    """
    bj, dj = _banks_on(taps, nfilts, x.device)
    kp = bj.shape[1]
    n_in = x.shape[0]
    # the reference's 3.5 API takes (alpha, beta) directly; later versions
    # derive them from a loop bandwidth (gri_control_loop) -- accept both
    alpha, beta = gains if gains is not None else \
        dsp.control_loop_gains(loop_bw)
    max_out = int(np.ceil(n_in / (sps * 0.95)))
    ar = torch.arange(kp, device=x.device)
    k, rate_f, base = state
    ys, valids, errs, rates, ks = [], [], [], [], []
    for _ in range(max_out):
        # kp-sample window at floor(base), start clamped into the input as
        # grtpu's dynamic_slice clamps it
        start = torch.clamp(torch.floor(base).long(), 0, n_in - kp)
        win = x[start + ar]
        ki = torch.clamp(torch.round(k).long(), 0, nfilts - 1).reshape(1)
        out = scan_dot(win, torch.index_select(bj, 0, ki)[0])
        dout = scan_dot(win, torch.index_select(dj, 0, ki)[0])
        err = _timing_error(out, dout)
        rate_f2 = torch.clamp(rate_f + beta * err, -max_dev, max_dev)
        k2 = k + rate_f2 + alpha * err
        # wrap filter index into [0, nfilts), carrying overflow into base
        shift = torch.floor(k2 / nfilts)
        k3 = k2 - shift * nfilts
        base2 = base + sps + shift
        # freeze the carry once past the end (masked slots don't advance)
        valid = base2 + kp <= n_in
        k = torch.where(valid, k3, k)
        rate_f = torch.where(valid, rate_f2, rate_f)
        base = torch.where(valid, base2, base)
        ys.append(out)
        valids.append(valid)
        if with_diag:
            errs.append(err)
            rates.append(rate_f2)
            ks.append(k3)
    n_valid = torch.stack(valids).sum().to(torch.int32)
    y = torch.stack(ys).to(x.dtype)
    if with_diag:
        # the reference block's optional outputs 1..3 (err, rate, phase)
        return ((y, torch.stack(errs), torch.stack(rates), torch.stack(ks)),
                n_valid, (k, rate_f, base))
    return y, n_valid, (k, rate_f, base)


def pfb_clock_sync_init(nfilts: int, device=None):
    device = resolve(device)
    return (_f32(nfilts / 2.0, device), _f32(0.0, device), _f32(0.0, device))


class PfbClockSync(Block):
    """gr_pfb_clock_sync_ccf as a variable-rate graph block.

    Returns ``(y_padded, n_valid)`` with the valid symbols a contiguous
    prefix; the executor compacts them through its carried FIFO.
    Chunk-boundary exactness: the carried sample pointer freezes at the last
    *emitted* symbol's next position, which can trail the chunk boundary by
    up to kp + sps + 1 samples — ``history`` covers that span so the
    deferred window stays readable after rebasing, and the loop's
    freeze-at-invalid semantics recompute the deferred symbol from identical
    state on the next chunk.  Chunked graph execution is therefore
    sample-identical to one full-stream run.  Matches gr_pfb_clock_sync_ccf
    general_work's variable consume."""

    variable_rate = True

    def __init__(self, sps: float, loop_bw: float, taps, nfilts: int = 32,
                 max_dev: float = 1.5, gains=None, init_phase=None,
                 diag: bool = False, name=None):
        self.in_ports = (Port(torch.complex64),)
        # diag adds the reference's optional err/rate/phase symbol-rate
        # outputs (gr_pfb_clock_sync_ccf ports 1..3)
        self.out_ports = ((Port(torch.complex64),)
                          + ((Port(torch.float32),) * 3 if diag else ()))
        self.diag = diag
        self.taps = np.asarray(taps)
        kp = -(-len(self.taps) // nfilts)
        self.history = kp + int(np.ceil(sps)) + 2
        super().__init__(name)
        self.sps, self.loop_bw = float(sps), float(loop_bw)
        self.nfilts, self.max_dev = int(nfilts), float(max_dev)
        self.gains = gains
        self.init_phase = nfilts / 2.0 if init_phase is None else init_phase

    @property
    def nominal_rate(self):
        return 1.0 / self.sps

    def max_out_for(self, n_delivered: int) -> int:
        return int(np.ceil(n_delivered / (self.sps * 0.95)))

    def init_state(self):
        return (torch.tensor(self.init_phase, dtype=torch.float32),
                torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.float32))

    def apply(self, state, x):
        ys, n_valid, st = pfb_clock_sync(
            x, state, self.sps, self.taps, self.nfilts, self.loop_bw,
            self.max_dev, self.gains, with_diag=self.diag)
        # rebase the sample pointer against the fresh items consumed; the
        # history halo keeps the deferred window readable next chunk
        k, rate_f, base = st
        st = (k, rate_f, base - (x.shape[0] - (self.history - 1)))
        return st, (ys, n_valid)


def pfb_clock_sync_windowed(x: torch.Tensor, state, sps: float,
                            taps: np.ndarray, nfilts: int, loop_bw: float,
                            max_dev: float = 1.5, W: int = 32):
    """Fixed-rate pfb_clock_sync at integer OR fractional sps (float sps is
    the reference contract, gr_pfb_clock_sync_ccf.cc).

    Same recursion as pfb_clock_sync over static-stride per-symbol rows.
    Rows follow the floor grid I_t = floor(t*sps) (loops._window_rows);
    since the exact loop's pointer is base_t = t*sps + R_t with R_t the
    integer sum of filter-phase wrap slips, floor(base_t) - I_t == R_t
    exactly, so the integer drift rides the state unchanged (clipped at
    +-W).

    x: ~(T-1)*sps + L samples with L = ceil(sps) + 2W + kp (W leading
    history).  state: (k, rate_f, rel).  Returns ((T,) symbols, new state).
    """
    bj, dj = _banks_on(taps, nfilts, x.device)
    kp = bj.shape[1]
    rows, _, T, L = _window_rows(x, sps, W, kp)
    alpha, beta = dsp.control_loop_gains(loop_bw)
    ar = torch.arange(kp, device=x.device)
    k, rate_f, rel = state
    ys = []
    for t in range(T):
        p = torch.round(rel).long() + W
        win = rows[t][p + ar]
        ki = torch.clamp(torch.round(k).long(), 0, nfilts - 1).reshape(1)
        out = scan_dot(win, torch.index_select(bj, 0, ki)[0])
        dout = scan_dot(win, torch.index_select(dj, 0, ki)[0])
        err = _timing_error(out, dout)
        rate_f = torch.clamp(rate_f + beta * err, -max_dev, max_dev)
        k2 = k + rate_f + alpha * err
        shift = torch.floor(k2 / nfilts)
        k = k2 - shift * nfilts
        rel = torch.clamp(rel + shift, float(-W + 1), float(W - 1))
        ys.append(out)
    y = torch.stack(ys).to(x.dtype) if ys else x.new_zeros((0,))
    return y, (k, rate_f, rel)


def pfb_clock_sync_windowed_init(nfilts: int, device=None):
    return pfb_clock_sync_init(nfilts, device)


def pfb_clock_sync_chunked(x: torch.Tensor, state, sps: float,
                           taps: np.ndarray, nfilts: int, loop_bw: float,
                           max_dev: float = 1.5, W: int = 32,
                           chunk: int = 64):
    """Chunk-batched pfb_clock_sync with pfb_clock_sync_windowed's loop
    semantics (same state, same floor-grid rows).

    Per chunk of Lc symbols:

      1. predict the filter-phase trajectory from the carry with the
         errors zeroed — k_t = k0 + t*rate is exact up to the intra-chunk
         alpha*err corrections, which the loop itself absorbs next chunk;
      2. gather the Lc windows and the Lc matched + derivative filter rows
         at once and take all the filter dots as one batch;
      3. compute all Lc timing errors at once and close the loop
         trajectory in cumsum form (rate_t = clip(rate0 + beta cumsum e),
         k unwrapped by cumsum, bank wraps by floor) for the carry.

    grtpu selects windows and bank rows with one-hot products whose right
    operand it rounds to bfloat16; the samples and the banks are rounded the
    same way here, and the sums stay float32.

    x layout identical to pfb_clock_sync_windowed.  Returns ((T,) symbols,
    state') with T truncated to a multiple of ``chunk``.  x is zero-padded
    so every chunk's span fits; grtpu instead clamps the last chunk's start
    when T is a multiple of ``chunk`` (see ROADMAP.md §3), so the two agree
    whenever T % chunk != 0.
    """
    bj, dj = _banks_on(taps, nfilts, x.device)
    kp = bj.shape[1]
    bj, dj = _bf16(bj), _bf16(dj)
    P, Q = rationalize_sps(sps)
    dmax = -(-P // Q)
    L = dmax + 2 * W + kp
    T = ((x.shape[0] - L) * Q) // P + 1
    Tc = (T // chunk) * chunk
    if Tc <= 0:
        return x.new_zeros((0,)), state
    nspan = (chunk * P) // Q + L                   # chunk's input span
    alpha, beta = dsp.control_loop_gains(loop_bw)
    dev = x.device
    ar = torch.arange(kp, device=dev)
    t_iota = torch.arange(chunk, dtype=torch.float32, device=dev)
    grid = (np.arange(Tc, dtype=np.int64) * P) // Q
    starts = grid[::chunk]
    # the same grid made on the device (no host-to-device copy a call, so a
    # CUDA graph can capture the call)
    gd = torch.arange(Tc, dtype=torch.int64, device=dev) * P // Q
    irel = gd.reshape(-1, chunk) - gd[::chunk, None]
    need = int(starts[-1]) + nspan
    xr = _bf16(torch.cat([x, x.new_zeros((max(0, need - x.shape[0]),))]))

    k, rate_f, rel = state
    out = []
    for c in range(Tc // chunk):
        # 1. err-free trajectory predictions from the carry
        ku = k + t_iota * rate_f                       # unwrapped
        shift = torch.floor(ku / nfilts)
        ki = torch.clamp(torch.round(ku - shift * nfilts).long(),
                         0, nfilts - 1)
        rel_t = torch.clamp(rel + shift, float(-W + 1), float(W - 1))
        p = torch.round(rel_t).long() + W              # (Lc,)
        # 2. symbol t's window starts at I_t + p_t with I_t = floor(t*P/Q)
        o = int(starts[c]) + irel[c] + p
        win = xr[o[:, None] + ar[None, :]]             # (Lc, kp)
        outs = (win * bj[ki]).sum(-1)
        douts = (win * dj[ki]).sum(-1)
        errs = _timing_error(outs, douts)
        # 3. closed-form loop trajectory for the carry
        rate_traj = torch.clamp(rate_f + beta * _cumsum(errs),
                                -max_dev, max_dev)
        ku2 = k + _cumsum(rate_traj + alpha * errs)
        shift2 = torch.floor(ku2 / nfilts)
        k = ku2[-1] - shift2[-1] * nfilts
        rel = torch.clamp(rel + shift2[-1], float(-W + 1), float(W - 1))
        rate_f = rate_traj[-1]
        out.append(outs.to(x.dtype))
    return torch.cat(out), (k, rate_f, rel)
