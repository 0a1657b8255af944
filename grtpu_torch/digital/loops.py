"""Digital synchronization loops, in PyTorch.

Port of the parts of ``grtpu.digital.loops`` that the modems and the digital
blocks call.  Analogs:
  * digital_costas_loop_cc (gr-digital/lib/digital_costas_loop_cc.cc:70-108):
    2nd/4th/8th-order carrier recovery on gri_control_loop.
  * digital_clock_recovery_mm_{ff,cc}
    (gr-digital/lib/digital_clock_recovery_mm_cc.cc:116-217): Mueller &
    Müller timing recovery with MMSE fractional interpolation and variable
    consumption.
  * digital_binary_slicer_fb, gr_diff_{encoder,decoder}_bb,
    gr_diff_phasor_cc.

The loops are sequential per-sample (Costas) or per-symbol (M&M)
recurrences.  Each runs as a Python loop over device tensors: the carried
state (phase, sample pointer, interpolator phase, drift) stays a 0-d tensor
on the stream's device, windows and tap rows are picked with ``torch.gather``
/ indexing at device-side indices, and no step reads a value back to the
host.  grtpu's one-hot selects (a TPU idiom: gathers are slow there) become
those gathers, which select the same values exactly.

Three M&M forms, as in grtpu:
  * exact (``clock_recovery_mm_ff/cc``): variable rate, ``max_out`` symbol
    slots with a valid count, the state frozen past the end of the input;
  * windowed (``clock_recovery_mm_{ff,cc}_windowed``): one symbol per
    nominal period, the timing drift carried as ``rel``;
  * chunked (``clock_recovery_mm_{ff,cc}_chunked``): whole chunks of symbols
    at once, the loop trajectory closed in cumsum form, two fixed-point
    sweeps, samples and taps rounded to bfloat16 as grtpu's one-hot matmuls
    round them.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple, Tuple

import numpy as np
import torch

from grtpu_torch.ops import dsp
from grtpu_torch.ops.mmse_interp import NSTEPS, NTAPS, bank_on, interpolate_point
from grtpu_torch.utils.device import resolve


def _f32(v, device) -> torch.Tensor:
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _sgn(v: torch.Tensor) -> torch.Tensor:
    """+1 where v > 0, else -1 (the loops' hard slicer)."""
    return torch.where(v > 0, 1.0, -1.0)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even), back to float32; complex by parts."""
    if v.is_complex():
        return torch.complex(_bf16(v.real), _bf16(v.imag))
    return v.to(torch.bfloat16).to(torch.float32)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive prefix sum along the last axis, summed in XLA's
    order for ``jnp.cumsum`` on a CPU: sequentially within blocks of 16,
    the blocks offset by the same scan of their totals.  (torch.cumsum sums
    in float64 on a CPU.)  The chunked M&M rounds these sums to pick
    interpolator phases, so the port sums them as grtpu does."""
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    m = -(-n // 16)
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (m * 16 - n,))], dim=-1)
    local = _cumsum(xp.reshape(x.shape[:-1] + (m, 16)))
    tot = _cumsum(local[..., -1])
    excl = torch.cat([tot.new_zeros(tot.shape[:-1] + (1,)), tot[..., :-1]], dim=-1)
    return (local + excl[..., None]).reshape(x.shape[:-1] + (m * 16,))[..., :n]


# ------------------------------------------------------------------ costas
def costas_phase_detector(order: int):
    """Order-specific phase detectors (digital_costas_loop_cc.cc:70-108)."""
    if order == 2:
        def det(s):
            return s.real * s.imag
    elif order == 4:
        def det(s):
            return _sgn(s.real) * s.imag - _sgn(s.imag) * s.real
    elif order == 8:
        K = math.sqrt(2.0) - 1.0

        def det(s):
            re, im = s.real, s.imag
            e1 = _sgn(re) * im - _sgn(im) * re * K
            e2 = _sgn(re) * im * K - _sgn(im) * re
            return torch.where(re.abs() >= im.abs(), e1, e2)
    else:
        raise ValueError("costas order must be 2, 4 or 8")
    return det


def costas_loop(x: torch.Tensor, state, loop_bw: float, order: int,
                gains=None):
    """Carrier-tracking derotation, one step per sample.  state = (phase,
    freq), 0-d float32 tensors.

    gains=(alpha, beta) overrides the loop-bandwidth derivation (the 3.5
    API exposes raw gains).  Returns (y, (phase, freq))."""
    alpha, beta = gains if gains is not None else \
        dsp.control_loop_gains(loop_bw)
    det = costas_phase_detector(order)
    phase, freq = state
    ys = []
    for i in range(x.shape[0]):
        y = x[i] * torch.complex(torch.cos(phase), -torch.sin(phase))
        err = torch.clamp(det(y), -1.0, 1.0)
        freq = freq + beta * err
        phase = dsp.phase_wrap(phase + freq + alpha * err)
        ys.append(y)
    y = torch.stack(ys) if ys else x.new_zeros((0,))
    return y, (phase, freq)


def costas_init_state(device=None):
    device = resolve(device)
    return (_f32(0.0, device), _f32(0.0, device))


# ------------------------------------------------------- clock recovery M&M
class MMState(NamedTuple):
    mu: torch.Tensor           # fractional interpolation phase [0,1)
    omega: torch.Tensor        # samples per symbol estimate
    base: torch.Tensor         # float sample pointer into the stream
    last_sample: torch.Tensor  # previous symbol decision input


def mm_init_state(omega: float, mu: float = 0.5, complex_mode=False,
                  device=None) -> MMState:
    device = resolve(device)
    dt = torch.complex64 if complex_mode else torch.float32
    return MMState(_f32(mu, device), _f32(omega, device), _f32(0.0, device),
                   torch.zeros((), dtype=dt, device=device))


def _ted(last: torch.Tensor, samp: torch.Tensor) -> torch.Tensor:
    """M&M timing error Re(conj(slc(last)) * samp - conj(slc(samp)) * last)
    with slc the per-part sign slicer; for real streams
    slc(last) * samp - slc(samp) * last."""
    if samp.is_complex():
        return ((_sgn(last.real) * samp.real + _sgn(last.imag) * samp.imag)
                - (_sgn(samp.real) * last.real + _sgn(samp.imag) * last.imag))
    return _sgn(last) * samp - _sgn(samp) * last


def _mm_exact(x, state: MMState, omega_nominal, gain_omega, gain_mu,
              omega_relative_limit, clip_err):
    n_in = x.shape[0]
    max_out = int(np.ceil(n_in / max(omega_nominal * (1 - omega_relative_limit), 1.0)))
    bank = bank_on(x.device)
    om_lim = omega_nominal * omega_relative_limit
    lo, hi = omega_nominal - om_lim, omega_nominal + om_lim
    ar = torch.arange(NTAPS, device=x.device)
    mu, omega, base, last = state
    ys, valids = [], []
    for _ in range(max_out):
        # 8-sample window at floor(base)+[0..7], start clamped into the
        # input as grtpu's dynamic_slice clamps it; interpolate at mu
        start = torch.clamp(torch.floor(base).long(), 0, n_in - NTAPS)
        samp = interpolate_point(x[start + ar], mu, bank)
        err = _ted(last, samp)
        if clip_err:
            err = torch.clamp(err, -1.0, 1.0)
        omega2 = torch.clamp(omega + gain_omega * err, lo, hi)
        step = mu + omega2 + gain_mu * err
        fl = torch.floor(step)
        newbase = base + fl
        # freeze the state once past the end (masked slots don't advance)
        valid = newbase + NTAPS <= n_in
        mu = torch.where(valid, step - fl, mu)
        omega = torch.where(valid, omega2, omega)
        base = torch.where(valid, newbase, base)
        last = torch.where(valid, samp, last)
        ys.append(samp)
        valids.append(valid)
    if not ys:
        return x.new_zeros((0,)), torch.zeros((), dtype=torch.int32,
                                              device=x.device), state
    n_valid = torch.stack(valids).sum().to(torch.int32)
    return torch.stack(ys), n_valid, MMState(mu, omega, base, last)


def clock_recovery_mm_ff(
    x: torch.Tensor, state: MMState, omega_nominal: float,
    gain_omega: float, gain_mu: float, omega_relative_limit: float = 0.001,
) -> Tuple[torch.Tensor, torch.Tensor, MMState]:
    """M&M timing recovery, float streams
    (digital_clock_recovery_mm_ff.cc general_work).

    x: n_in + lookahead samples.  Returns (y_padded, n_valid, new_state):
    ``max_out`` symbol slots, a 0-d int32 count of the valid prefix (on the
    device), and the carried state (its ``base`` still relative to x[0];
    :func:`rebase_mm_state` shifts it for the next chunk)."""
    return _mm_exact(x, state, omega_nominal, gain_omega, gain_mu,
                     omega_relative_limit, clip_err=False)


def clock_recovery_mm_cc(
    x: torch.Tensor, state: MMState, omega_nominal: float,
    gain_omega: float, gain_mu: float, omega_relative_limit: float = 0.001,
) -> Tuple[torch.Tensor, torch.Tensor, MMState]:
    """M&M timing recovery on complex streams
    (digital_clock_recovery_mm_cc.cc:116-217: conjugated-decision error,
    clipped to [-1, 1])."""
    return _mm_exact(x, state, omega_nominal, gain_omega, gain_mu,
                     omega_relative_limit, clip_err=True)


def rebase_mm_state(state: MMState, consumed: int) -> MMState:
    """Shift the sample pointer after the caller drops ``consumed`` input
    samples (chunk advance)."""
    return state._replace(base=state.base - consumed)


# -------------------------------------------------------------- binary slicer
def binary_slicer(x: torch.Tensor) -> torch.Tensor:
    """digital_binary_slicer_fb: >= 0 -> 1 else 0."""
    return (x >= 0).to(torch.uint8)


# ------------------------------------------------------------- differential
def diff_encode(x: torch.Tensor, state, modulus: int):
    """gr_diff_encoder_bb: y[i] = (x[i] + y[i-1]) % M, as a prefix sum."""
    c = torch.remainder(torch.cumsum(x.to(torch.int64), dim=0)
                        + state.to(torch.int64), modulus)
    return c.to(x.dtype), c[-1].to(x.dtype)


def diff_decode(x: torch.Tensor, state, modulus: int):
    """gr_diff_decoder_bb: y[i] = (x[i] - x[i-1]) % M (state = previous)."""
    prev = torch.cat([state.reshape(1).to(x.dtype), x[:-1]])
    y = torch.remainder(x.to(torch.int32) - prev.to(torch.int32), modulus)
    return y.to(x.dtype), x[-1]


def diff_phasor(x: torch.Tensor, state):
    """gr_diff_phasor_cc: y[i] = x[i] * conj(x[i-1])."""
    prev = torch.cat([state.reshape(1), x[:-1]])
    return (x * torch.conj(prev)).to(torch.complex64), x[-1]


# ------------------------------------------------- windowed (fast) M&M
#
# In lock the sample pointer stays within a bounded drift of t*sps, so the
# chunk is cut into per-symbol rows on the nominal clock's floor grid and
# the drift is carried in the state: one symbol per nominal period (a
# fixed-rate form), recursion and interpolator identical to the exact form
# while |drift| < W.


class MMWinState(NamedTuple):
    mu: torch.Tensor
    omega: torch.Tensor
    rel: torch.Tensor          # drift (samples) from the nominal t*sps
    last_sample: torch.Tensor


def mm_windowed_init_state(omega: float, mu: float = 0.5,
                           complex_mode=False, device=None) -> MMWinState:
    device = resolve(device)
    dt = torch.complex64 if complex_mode else torch.float32
    return MMWinState(_f32(mu, device), _f32(omega, device),
                      _f32(0.0, device), torch.zeros((), dtype=dt,
                                                     device=device))


def rationalize_sps(sps: float, max_denominator: int = 64):
    """Nominal samples/symbol -> (P, Q) with P/Q = sps to within
    1/(max_denominator^2).  Q == 1 is the integer case."""
    fr = Fraction(float(sps)).limit_denominator(max_denominator)
    return fr.numerator, fr.denominator


def _window_rows(x: torch.Tensor, sps: float, W: int, width: int):
    """Per-symbol rows on the floor grid of the nominal clock.

    Symbol t's row starts at I_t = floor(t*P/Q) (P/Q = rationalized sps):
    rows[t, k] = x[I_t + k] (zero past the end of x), L = ceil(P/Q) + 2W +
    width.  x carries W leading history samples.  One gather.

    Returns (rows, d, T, L) with d[t] = I_{t+1} - I_t (float32 tensor), the
    per-symbol nominal integer-grid advance the loop recursion consumes."""
    P, Q = rationalize_sps(sps)
    L = -(-P // Q) + 2 * W + width
    Tq = (x.shape[0] - L - (((Q - 1) * P) // Q)) // P + 1
    T = Q * Tq
    grid = (np.arange(T + 1, dtype=np.int64) * P) // Q
    need = int(grid[T - 1]) + L if T > 0 else 0
    xp = torch.cat([x, x.new_zeros((max(0, need - x.shape[0]),))])
    idx = (torch.from_numpy(grid[:-1]).to(x.device)[:, None]
           + torch.arange(L, device=x.device)[None, :])
    d = torch.from_numpy((grid[1:] - grid[:-1]).astype(np.float32)).to(x.device)
    return xp[idx], d, T, L


def _mm_windowed(x, state, sps, gain_omega, gain_mu, omega_relative_limit,
                 W):
    if W is None:
        raise ValueError("W must be set")
    P, Q = rationalize_sps(sps)
    sps_nom = P / Q
    om_lim = sps_nom * omega_relative_limit
    lo, hi = sps_nom - om_lim, sps_nom + om_lim
    rows, d, T, L = _window_rows(x, sps, W, NTAPS)
    bank = bank_on(x.device)
    ar = torch.arange(NTAPS, device=x.device)
    mu, omega, rel, last = state
    ys = []
    for t in range(T):
        p = torch.round(rel).long() + W
        samp = interpolate_point(rows[t][p + ar], mu, bank)
        err = torch.clamp(_ted(last, samp), -1.0, 1.0)
        omega = torch.clamp(omega + gain_omega * err, lo, hi)
        step = mu + omega + gain_mu * err
        adv = torch.floor(step)
        # the loop pointer advances by adv samples; the nominal grid the
        # rows follow advances by d[t]: the drift moves by the difference
        rel = torch.clamp(rel + adv - d[t], float(-W + 1), float(W - 1))
        mu = step - adv
        last = samp
        ys.append(samp)
    y = torch.stack(ys) if ys else x.new_zeros((0,))
    return y, MMWinState(mu, omega, rel, last)


def clock_recovery_mm_ff_windowed(
        x: torch.Tensor, state: MMWinState, sps: float,
        gain_omega: float, gain_mu: float,
        omega_relative_limit: float = 0.001, W: int = 32):
    """Fixed-rate M&M at integer OR fractional samples/symbol: rows ride
    the floor grid of the rationalized nominal clock, so ~T*sps + 2W + NTAPS
    samples (incl. W history) -> exactly (T,) symbols.  Identical to
    clock_recovery_mm_ff while the timing drift stays inside +-W."""
    return _mm_windowed(x, state, sps, gain_omega, gain_mu,
                        omega_relative_limit, W)


def clock_recovery_mm_cc_windowed(
        x: torch.Tensor, state: MMWinState, sps: float,
        gain_omega: float, gain_mu: float,
        omega_relative_limit: float = 0.001, W: int = 32):
    """Complex windowed M&M (conjugated-decision TED, as
    clock_recovery_mm_cc)."""
    return _mm_windowed(x, state, sps, gain_omega, gain_mu,
                        omega_relative_limit, W)


def _mm_chunked(x, state, sps, gain_omega, gain_mu, omega_relative_limit,
                W, chunk):
    """Chunk-batched M&M with _mm_windowed's loop semantics.

    Per chunk of Lc symbols: predict the interpolator-phase/pointer
    trajectories from the carry with the errors zeroed, gather the Lc
    windows and tap rows at once, derive all Lc timing errors from the batch
    (err_t couples consecutive symbols only through samp_{t-1}), re-derive
    the trajectory from the error batch (two fixed-point sweeps), and close
    the omega/mu trajectory in cumsum form for the carry.

    grtpu picks windows and taps with one-hot products whose right operand
    it rounds to bfloat16 (loops.py ``mm``); the samples and the tap bank
    are rounded the same way here, and the sums stay float32.

    x layout identical to the windowed form.  Returns ((T,) symbols,
    state') with T truncated to a multiple of ``chunk``.  x is zero-padded
    so every chunk's span fits; grtpu instead clamps the last chunk's start
    when T is a multiple of ``chunk`` (see ROADMAP.md §3), so the two agree
    whenever T % chunk != 0."""
    P, Q = rationalize_sps(sps)
    sps_nom = P / Q
    om_lim = sps_nom * omega_relative_limit
    lo, hi = sps_nom - om_lim, sps_nom + om_lim
    L = -(-P // Q) + 2 * W + NTAPS
    T = ((x.shape[0] - L) * Q) // P + 1
    Tc = (T // chunk) * chunk
    if Tc <= 0:
        return x.new_zeros((0,)), state
    nspan = (chunk * P) // Q + L
    dev = x.device
    bank = _bf16(bank_on(dev))
    ar = torch.arange(NTAPS, device=dev)
    # nominal grid, per chunk relative to the chunk's first row
    grid = (np.arange(Tc + 1, dtype=np.int64) * P) // Q
    starts = grid[:-1:chunk]
    irel_np = grid[:-1].reshape(-1, chunk) - starts[:, None]
    irel_i = torch.from_numpy(irel_np).to(dev)
    irel_f = irel_i.to(torch.float32)
    dtot = torch.from_numpy((grid[chunk::chunk] - starts).astype(np.float32)).to(dev)
    need = int(starts[-1]) + nspan
    xr = _bf16(torch.cat([x, x.new_zeros((max(0, need - x.shape[0]),))]))

    mu, omega, rel, last = state
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    out = []
    for c in range(Tc // chunk):
        i0 = int(starts[c])
        irel = irel_f[c]
        errs = torch.zeros(chunk, dtype=torch.float32, device=dev)
        for _ in range(2):
            om_traj = torch.clamp(omega + gain_omega * _cumsum(errs),
                                  lo, hi)
            # unwrapped mu BEFORE symbol t
            M = mu + torch.cat([zero, _cumsum(om_traj + gain_mu * errs)[:-1]])
            Mf = torch.floor(M)
            rel_t = torch.clamp(rel + Mf - irel, float(-W + 1), float(W - 1))
            o = irel_i[c] + torch.round(rel_t).long() + W
            phase = torch.round((M - Mf) * NSTEPS).long()
            win = xr[i0 + o[:, None] + ar[None, :]]          # (Lc, NTAPS)
            samps = (win * bank[phase]).sum(-1).to(x.dtype)
            prev = torch.cat([last.reshape(1), samps[:-1]])
            errs = torch.clamp(_ted(prev, samps), -1.0, 1.0)
        # closed-form carry from the final error batch
        om_traj = torch.clamp(omega + gain_omega * _cumsum(errs),
                              lo, hi)
        M2 = mu + _cumsum(om_traj + gain_mu * errs)
        M2f = torch.floor(M2[-1])
        mu = M2[-1] - M2f
        omega = om_traj[-1]
        rel = torch.clamp(rel + M2f - dtot[c], float(-W + 1), float(W - 1))
        last = samps[-1]
        out.append(samps)
    return torch.cat(out), MMWinState(mu, omega, rel, last)


def clock_recovery_mm_ff_chunked(
        x: torch.Tensor, state: MMWinState, sps: float,
        gain_omega: float, gain_mu: float,
        omega_relative_limit: float = 0.001, W: int = 32,
        chunk: int = 64):
    """Chunk-batched float M&M (see _mm_chunked)."""
    return _mm_chunked(x, state, sps, gain_omega, gain_mu,
                       omega_relative_limit, W, chunk)


def clock_recovery_mm_cc_chunked(
        x: torch.Tensor, state: MMWinState, sps: float,
        gain_omega: float, gain_mu: float,
        omega_relative_limit: float = 0.001, W: int = 32,
        chunk: int = 64):
    """Chunk-batched complex M&M (see _mm_chunked)."""
    return _mm_chunked(x, state, sps, gain_omega, gain_mu,
                       omega_relative_limit, W, chunk)
