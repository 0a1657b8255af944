"""Digital synchronization loops, in PyTorch.

Port of the parts of ``grtpu.digital.loops`` that the modems and the digital
blocks call.  Analogs:
  * digital_costas_loop_cc (gr-digital/lib/digital_costas_loop_cc.cc:70-108):
    2nd/4th/8th-order carrier recovery on gri_control_loop.
  * digital_clock_recovery_mm_{ff,cc}
    (gr-digital/lib/digital_clock_recovery_mm_cc.cc:116-217): Mueller &
    Müller timing recovery with MMSE fractional interpolation and variable
    consumption.
  * digital_fll_band_edge_cc (lib/digital_fll_band_edge_cc.cc): frequency-
    locked loop on the band-edge filters' power difference.
  * gr_agc2_cc, chunk-batched (the per-sample AGC2 is ``blocks.analog.Agc2``).
  * digital_constellation_receiver_cb: NCO derotation with a decision-
    directed phase error.
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
    on the card one launch of the ``mm_fwd`` hand kernel
    (:mod:`grtpu_torch.ops.cuda_mm`), on the CPU the loop :func:`_mm_exact`;
  * windowed (``clock_recovery_mm_{ff,cc}_windowed``): one symbol per
    nominal period, the timing drift carried as ``rel``; one stream or a
    batch, the symbol loop through ``step_scan`` (graph replays on the
    card);
  * chunked (``clock_recovery_mm_{ff,cc}_chunked``): whole chunks of symbols
    at once, the loop trajectory closed in cumsum form, two fixed-point
    sweeps, samples and taps rounded to bfloat16 as grtpu's one-hot matmuls
    round them.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import NamedTuple, Tuple

import numpy as np
import torch

from grtpu_torch.ops import cuda_mm, dsp
from grtpu_torch.ops.mmse_interp import (NSTEPS, NTAPS, bank_on,
                                         interpolate_point, scan_dot)
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


def _cumsum(x: torch.Tensor, op=torch.add, fill: float = 0.0) -> torch.Tensor:
    """float32 inclusive prefix sum along the last axis, summed in XLA's
    order for ``jnp.cumsum`` on a CPU: sequentially within blocks of 16,
    the blocks offset by the same scan of their totals.  (torch.cumsum sums
    in float64 on a CPU.)  The chunked M&M rounds these sums to pick
    interpolator phases, so the port sums them as grtpu does.  ``op`` /
    ``fill`` = ``torch.mul`` / 1 give ``jnp.cumprod`` in the same order."""
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(op(cols[-1], x[..., j]))
        return torch.stack(cols, dim=-1)
    m = -(-n // 16)
    xp = torch.cat([x, x.new_full(x.shape[:-1] + (m * 16 - n,), fill)], dim=-1)
    local = _cumsum(xp.reshape(x.shape[:-1] + (m, 16)), op, fill)
    tot = _cumsum(local[..., -1], op, fill)
    excl = torch.cat([tot.new_full(tot.shape[:-1] + (1,), fill), tot[..., :-1]],
                     dim=-1)
    return op(local, excl[..., None]).reshape(x.shape[:-1] + (m * 16,))[..., :n]


def _cumprod(x: torch.Tensor) -> torch.Tensor:
    return _cumsum(x, torch.mul, 1.0)


@functools.lru_cache(maxsize=64)
def _host_const(data: bytes, dtype: str, shape, device: torch.device):
    arr = np.frombuffer(data, dtype=dtype).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def _on(arr: np.ndarray, device) -> torch.Tensor:
    """A host numpy constant as a tensor on ``device``, copied once."""
    arr = np.ascontiguousarray(arr)
    return _host_const(arr.tobytes(), arr.dtype.str, arr.shape,
                       torch.device(device))


def _expj(ph: torch.Tensor) -> torch.Tensor:
    """exp(-1j * ph) for real ph, as complex64."""
    return torch.polar(torch.ones_like(ph), -ph)


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


def _mm(x, state: MMState, omega_nominal, gain_omega, gain_mu,
        omega_relative_limit, cc):
    """The exact M&M: one launch of the ``mm_fwd`` kernel on a CUDA tensor
    (:mod:`grtpu_torch.ops.cuda_mm`, bit for bit the plain loop), the plain
    loop :func:`_mm_exact` on a CPU tensor."""
    if x.device.type == "cuda":
        ys, n_valid, *st = cuda_mm.mm_fwd(x, *state, omega_nominal, gain_omega,
                                          gain_mu, omega_relative_limit, cc)
        return ys, n_valid, MMState(*st)
    return _mm_exact(x, state, omega_nominal, gain_omega, gain_mu,
                     omega_relative_limit, clip_err=cc)


def clock_recovery_mm_ff(
    x: torch.Tensor, state: MMState, omega_nominal: float,
    gain_omega: float, gain_mu: float, omega_relative_limit: float = 0.001,
) -> Tuple[torch.Tensor, torch.Tensor, MMState]:
    """M&M timing recovery, float streams
    (digital_clock_recovery_mm_ff.cc general_work).

    x: n_in + lookahead samples.  Returns (y_padded, n_valid, new_state):
    ``max_out`` symbol slots, a 0-d int32 count of the valid prefix (on the
    device), and the carried state (its ``base`` still relative to x[0];
    :func:`rebase_mm_state` shifts it for the next chunk).  On the card,
    one launch of the ``mm_fwd`` kernel."""
    return _mm(x, state, omega_nominal, gain_omega, gain_mu,
               omega_relative_limit, cc=False)


def clock_recovery_mm_cc(
    x: torch.Tensor, state: MMState, omega_nominal: float,
    gain_omega: float, gain_mu: float, omega_relative_limit: float = 0.001,
) -> Tuple[torch.Tensor, torch.Tensor, MMState]:
    """M&M timing recovery on complex streams
    (digital_clock_recovery_mm_cc.cc:116-217: conjugated-decision error,
    clipped to [-1, 1]).  On the card, one launch of the ``mm_fwd``
    kernel."""
    return _mm(x, state, omega_nominal, gain_omega, gain_mu,
               omega_relative_limit, cc=True)


def rebase_mm_state(state: MMState, consumed: int) -> MMState:
    """Shift the sample pointer after the caller drops ``consumed`` input
    samples (chunk advance)."""
    return state._replace(base=state.base - consumed)


# -------------------------------------------------------------- binary slicer
def binary_slicer(x: torch.Tensor) -> torch.Tensor:
    """digital_binary_slicer_fb: >= 0 -> 1 else 0."""
    return (x >= 0).to(torch.uint8)


# ------------------------------------------------------------- FLL band edge
def band_edge_taps(samps_per_sym: float, rolloff: float, filter_size: int):
    """Band-edge filter pair (digital_fll_band_edge_cc::design_filter):
    derivative-of-RRC band-edge responses centered at +/- (1+rolloff)/2T.
    Host numpy (a copy of grtpu's), convolution orientation."""
    M = filter_size
    power = 0.0
    bb_taps = []
    for i in range(M):
        k = -M / 2 + i
        t = np.sinc(2 * rolloff * k / samps_per_sym - 0.5) + \
            np.sinc(2 * rolloff * k / samps_per_sym + 0.5)
        power += t * t
        bb_taps.append(t)
    bb = np.asarray(bb_taps) / np.sqrt(power)
    n = np.arange(M) - (M - 1.0) / 2.0
    fc = (1.0 + rolloff) / (2.0 * samps_per_sym)  # cycles/sample
    upper = bb * np.exp(2j * np.pi * fc * n)
    lower = bb * np.exp(-2j * np.pi * fc * n)
    return (upper.astype(np.complex64)[::-1], lower.astype(np.complex64)[::-1])


def _power(v: torch.Tensor) -> torch.Tensor:
    return v.real ** 2 + v.imag ** 2


def fll_band_edge(x: torch.Tensor, state, samps_per_sym: float,
                  rolloff: float, filter_size: int, loop_bw: float,
                  gains=None):
    """FLL: rotate by the NCO, filter with the band-edge pair, frequency
    error = |upper|^2 - |lower|^2 (clipped to [-1, 1]), 2nd-order loop with
    the frequency clipped to +-2pi/sps on every step.  state = (phase, freq).

    One step per sample (the filters see the *rotated* signal: true
    feedback).  x carries filter_size-1 history samples.  gains=(alpha,
    beta) overrides the bandwidth derivation (the 3.5 raw-gain API).
    Returns (y, (phase, freq))."""
    alpha, beta = gains if gains is not None else \
        dsp.control_loop_gains(loop_bw)
    pair = _on(np.stack(band_edge_taps(samps_per_sym, rolloff, filter_size)),
               x.device)                              # (2, K): upper, lower
    K = filter_size
    n = x.shape[0] - (K - 1)
    fmax = 2 * np.pi / samps_per_sym
    karr = torch.arange(K, dtype=torch.float32, device=x.device) - (K - 1)
    phase, freq = state
    ys = []
    for i in range(n):
        win = x[i:i + K]
        # rotate the window by the *current* NCO ramp ending at this sample
        pw = _power((win * _expj(phase + freq * karr) * pair).sum(-1))
        err = torch.clamp(pw[0] - pw[1], -1.0, 1.0)
        freq2 = torch.clamp(freq + beta * err, -fmax, fmax)
        ys.append(win[K - 1] * _expj(phase))
        phase = dsp.phase_wrap(phase + freq2 + alpha * err)
        freq = freq2
    y = torch.stack(ys) if ys else x.new_zeros((0,))
    return y, (phase, freq)


def fll_init_state(device=None):
    device = resolve(device)
    return (_f32(0.0, device), _f32(0.0, device))


def fll_band_edge_chunked(x: torch.Tensor, state, samps_per_sym: float,
                          rolloff: float, filter_size: int, loop_bw: float,
                          gains=None, chunk: int = 64):
    """Chunk-batched FLL with fll_band_edge's loop semantics.

    The frequency error |BE_up(x_rot)|^2 - |BE_lo(x_rot)|^2 does not depend
    on the NCO phase, and on the loop frequency only through the slow ramp
    across the K-tap window.  So per chunk of L samples: freeze the
    frequency at the carry, modulate the band-edge taps by its ramp and take
    all L errors with two (L, K) matvecs; close the loop trajectory in
    cumsum form; derotate the chunk with the batched phase ramp.

    Rails as in grtpu: the frequency is clipped once on the cumulative sum
    (clip(f0 + beta cumsum err)), not on every step as fll_band_edge clips
    it, so a loop held at the rail leaves it differently within a chunk.

    x carries filter_size-1 history samples; n = len(x) - (K-1) must be a
    multiple of ``chunk``.  Returns (y, (phase, freq))."""
    alpha, beta = gains if gains is not None else \
        dsp.control_loop_gains(loop_bw)
    up, lo = band_edge_taps(samps_per_sym, rolloff, filter_size)
    dev = x.device
    upj, loj = _on(up, dev), _on(lo, dev)
    K = filter_size
    n = x.shape[0] - (K - 1)
    if n % chunk:
        raise ValueError(f"n ({n}) must be a multiple of chunk ({chunk})")
    fmax = float(np.float32(2 * np.pi / samps_per_sym))
    two_pi = float(np.float32(2 * np.pi))
    karr = torch.arange(K, dtype=torch.float32, device=dev) - (K - 1)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    wins = x.unfold(0, K, 1)                            # (n, K) windows
    phase, freq = state
    out = []
    for i0 in range(0, n, chunk):
        W = wins[i0:i0 + chunk]
        rot = _expj(freq * karr)
        # the two matvecs as row sums: a vmapped bank then sums each row as
        # a single channel does (a batched matmul would sum in its own order)
        errs = torch.clamp(_power((W * (upj * rot)).sum(-1))
                           - _power((W * (loj * rot)).sum(-1)), -1.0, 1.0)
        freq_traj = torch.clamp(freq + beta * _cumsum(errs), -fmax, fmax)
        dphi = _cumsum(freq_traj + alpha * errs)  # applied AFTER sample t
        phases = phase + torch.cat([zero, dphi[:-1]])
        out.append(W[:, K - 1] * _expj(phases))
        phase = torch.remainder(phase + dphi[-1], two_pi)
        freq = freq_traj[-1]
    y = torch.cat(out) if out else x.new_zeros((0,))
    return y, (phase, freq)


# -------------------------------------------------------------------- agc2
def agc2_chunked(x: torch.Tensor, gain0, attack_rate: float = 1e-1,
                 decay_rate: float = 1e-2, reference: float = 1.0,
                 chunk: int = 64):
    """Chunk-batched AGC2 with grtpu's rule: err = ref - |x g|, rate
    attack_rate where err < 0 (the output is too loud) else decay_rate,
    g += rate * err (gr_agc2_cc instead takes the attack rate where
    |x g| - ref exceeds the gain, and clamps the gain; grtpu does neither).

    The gain recurrence g' = g (1 - r |x|) + r ref is linear once the rate
    r_t is fixed; per chunk the rate is predicted from the carry gain and
    the recurrence closes in cumprod / cumsum form, g_t = P_t (g0 + sum B/P),
    with P floored at 1e-30 as in grtpu: where r |x| > 1 the product turns
    negative and the closed form leaves the per-sample recurrence (a fault
    of the reference, reproduced; see ROADMAP.md §3).  n must be a multiple
    of ``chunk``.  Returns (y, gain')."""
    n = x.shape[-1]
    if n % chunk:
        raise ValueError(f"n ({n}) must be a multiple of chunk ({chunk})")
    att, dec, ref = (float(np.float32(attack_rate)),
                     float(np.float32(decay_rate)), float(np.float32(reference)))
    a = x.abs()
    g0 = (gain0.to(torch.float32) if isinstance(gain0, torch.Tensor)
          else _f32(gain0, x.device))
    out = []
    for i0 in range(0, n, chunk):
        seg_a, seg_x = a[i0:i0 + chunk], x[i0:i0 + chunk]
        r = torch.where(ref - g0 * seg_a < 0, att, dec)
        A = 1.0 - r * seg_a                   # g_{t+1} = A_t g_t + B_t
        P = _cumprod(A)
        S = _cumsum((r * ref) / torch.clamp(P, min=1e-30))
        g_after = P * (g0 + S)
        # y_t uses the gain BEFORE its own update
        out.append(seg_x * torch.cat([g0.reshape(1), g_after[:-1]]))
        g0 = g_after[-1]
    y = torch.cat(out) if out else x
    return y.to(x.dtype), g0


# ------------------------------------------------- constellation receiver
def _nearest(y: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Index of the nearest point (first on ties, as jnp.argmin)."""
    return torch.argmin(torch.abs(y[..., None] - pts) ** 2, dim=-1)


def _point(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts[idx] for a 0-d index tensor, without reading it on the host
    (indexing with a 0-d tensor would, which a CUDA graph cannot hold)."""
    return torch.index_select(pts, 0, idx.reshape(1))[0]


def _dd_error(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    e = y * torch.conj(ref)
    return torch.atan2(e.imag, e.real)


def constellation_receiver(x: torch.Tensor, state, constellation,
                           loop_bw: float):
    """digital_constellation_receiver_cb: NCO derotation with a decision-
    directed phase error from the constellation, one step per symbol.
    Returns (symbols int32, y, state)."""
    alpha, beta = dsp.control_loop_gains(loop_bw)
    pts = _on(constellation.points, x.device)
    phase, freq = state
    syms, ys = [], []
    for i in range(x.shape[0]):
        y = x[i] * _expj(phase)
        sym = _nearest(y, pts)
        err = _dd_error(y, _point(pts, sym))
        freq = freq + beta * err
        phase = dsp.phase_wrap(phase + freq + alpha * err)
        syms.append(sym)
        ys.append(y)
    if not ys:
        return (torch.zeros(0, dtype=torch.int32, device=x.device), x,
                (phase, freq))
    return (torch.stack(syms).to(torch.int32), torch.stack(ys),
            (phase, freq))


def constellation_receiver_chunked(x: torch.Tensor, state, constellation,
                                   loop_bw: float, chunk: int = 32,
                                   refine: int = 2):
    """Chunk-batched constellation receiver with constellation_receiver's
    loop semantics.  Per chunk: predict the phase ramp from the carried
    (phase, freq), derotate and decide all symbols at once, then re-solve
    the loop trajectory from the batch of phase errors in closed form
    (``refine`` sweeps, the errors re-derived from the corrected ramp each
    sweep).  len(x) must be a multiple of ``chunk``.
    Returns (symbols int32, y, state)."""
    alpha, beta = dsp.control_loop_gains(loop_bw)
    dev = x.device
    pts = _on(constellation.points, dev)
    t0 = torch.arange(chunk, dtype=torch.float32, device=dev)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    phase, freq = state
    syms, ys = [], []
    for i0 in range(0, x.shape[-1], chunk):
        seg = x[i0:i0 + chunk]
        ph = phase + freq * t0                    # freq-only prediction
        for _ in range(refine):
            y = seg * _expj(ph)
            errs = _dd_error(y, pts[_nearest(y, pts)])
            freq_traj = freq + beta * _cumsum(errs)
            dphi = _cumsum(freq_traj + alpha * errs)
            ph = phase + torch.cat([zero, dphi[:-1]])
        y = seg * _expj(ph)
        syms.append(_nearest(y, pts).to(torch.int32))
        ys.append(y)
        phase = dsp.phase_wrap(phase + dphi[-1])
        freq = freq_traj[-1]
    if not ys:
        return (torch.zeros(0, dtype=torch.int32, device=dev), x,
                (phase, freq))
    return torch.cat(syms), torch.cat(ys), (phase, freq)


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
    width.  x carries W leading history samples; leading axes of x are
    batch axes (rows (..., T, L)).  One gather.

    Returns (rows, d, T, L) with d[t] = I_{t+1} - I_t (float32 tensor), the
    per-symbol nominal integer-grid advance the loop recursion consumes."""
    P, Q = rationalize_sps(sps)
    L = -(-P // Q) + 2 * W + width
    Tq = (x.shape[-1] - L - (((Q - 1) * P) // Q)) // P + 1
    T = Q * Tq
    grid = (np.arange(T + 1, dtype=np.int64) * P) // Q
    need = int(grid[T - 1]) + L if T > 0 else 0
    xp = torch.cat([x, x.new_zeros(x.shape[:-1]
                                   + (max(0, need - x.shape[-1]),))], dim=-1)
    idx = (torch.from_numpy(grid[:-1]).to(x.device)[:, None]
           + torch.arange(L, device=x.device)[None, :])
    d = torch.from_numpy((grid[1:] - grid[:-1]).astype(np.float32)).to(x.device)
    return xp[..., idx], d, T, L


def _mm_window_rows(x: torch.Tensor, sps: int, W: int):
    """(T, L) rows with rows[t, k] = x[t*sps + k] (integer-sps legacy
    surface; the general form is :func:`_window_rows`)."""
    rows, _, T, L = _window_rows(x, int(sps), W, NTAPS)
    return rows, T, L


def _mm_windowed(x, state, sps, gain_omega, gain_mu, omega_relative_limit,
                 W):
    """The windowed M&M recursion over one stream x (n,) with state fields
    0-d, or over a batch of streams, one a row of x (B, n), each with its
    own state (the fields (B,)): the arithmetic is elementwise over the
    rows, so each row equals its stream run alone.  The symbol loop runs
    through ``runtime.step_graph.step_scan`` (on the card, UNROLL symbols a
    CUDA graph replay)."""
    from grtpu_torch.runtime.step_graph import step_scan

    if W is None:
        raise ValueError("W must be set")
    if x.dim() == 1:
        y, st = _mm_windowed(x[None], MMWinState(*(f.reshape(1)
                                                   for f in state)),
                             sps, gain_omega, gain_mu, omega_relative_limit, W)
        return y[0], MMWinState(*(f.reshape(f0.shape)
                                  for f, f0 in zip(st, state)))
    P, Q = rationalize_sps(sps)
    sps_nom = P / Q
    om_lim = sps_nom * omega_relative_limit
    lo, hi = sps_nom - om_lim, sps_nom + om_lim
    rows, d, T, L = _window_rows(x, sps, W, NTAPS)
    dev = x.device
    bank = bank_on(dev)
    ar = torch.arange(NTAPS, device=dev)
    B = x.shape[0]
    # each step's rows, with the nominal grid's advance d[t] as one more
    # column (small integers: exact in float32)
    xs = torch.cat([rows.transpose(0, 1),
                    d.to(x.dtype)[:, None, None].expand(T, B, 1)], dim=2)

    def step(st, xt):
        mu, omega, rel, last = st
        p = torch.round(rel).long() + W
        win = torch.gather(xt[:, :L], 1, p[:, None] + ar[None, :])
        taps = torch.index_select(bank, 0, torch.round(mu * NSTEPS).long())
        samp = scan_dot(win, taps)
        err = torch.clamp(_ted(last, samp), -1.0, 1.0)
        omega = torch.clamp(omega + gain_omega * err, lo, hi)
        step_ = mu + omega + gain_mu * err
        adv = torch.floor(step_)
        # the loop pointer advances by adv samples; the nominal grid the
        # rows follow advances by d[t]: the drift moves by the difference
        rel = torch.clamp(rel + adv - xt[:, L].real, float(-W + 1),
                          float(W - 1))
        return (step_ - adv, omega, rel, samp), samp

    out = torch.empty((T, B), dtype=x.dtype, device=dev)
    st = step_scan(step, tuple(state), xs, out) if T else tuple(state)
    return out.transpose(0, 1), MMWinState(*st)


def clock_recovery_mm_ff_windowed(
        x: torch.Tensor, state: MMWinState, sps: float,
        gain_omega: float, gain_mu: float,
        omega_relative_limit: float = 0.001, W: int = 32):
    """Fixed-rate M&M at integer OR fractional samples/symbol: rows ride
    the floor grid of the rationalized nominal clock, so ~T*sps + 2W + NTAPS
    samples (incl. W history) -> exactly (T,) symbols.  Identical to
    clock_recovery_mm_ff while the timing drift stays inside +-W.

    x (B, n) runs B independent streams as a batch (grtpu vmaps the
    function), each state field (B,): (B, T) symbols, each row equal to
    its stream run alone."""
    return _mm_windowed(x, state, sps, gain_omega, gain_mu,
                        omega_relative_limit, W)


def clock_recovery_mm_cc_windowed(
        x: torch.Tensor, state: MMWinState, sps: float,
        gain_omega: float, gain_mu: float,
        omega_relative_limit: float = 0.001, W: int = 32):
    """Complex windowed M&M (conjugated-decision TED, as
    clock_recovery_mm_cc); x (B, n) runs a batch, as the real form."""
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
