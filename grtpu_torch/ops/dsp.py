"""Scalar DSP primitives: rotator, NCO, FM discriminator, FM and phase
modulators, first-order recurrences, IIR filters, control-loop helpers and
the DC blocker, in PyTorch.

Port of ``grtpu.ops.dsp``.  Analogs of:
  * gr_rotator.h / gri_fxpt NCO — complex phase rotation and waveform
    synthesis: the whole time-block's phase ramp is made at once in float32
    with a carried phase scalar, wrapped each chunk.
  * gr_quadrature_demod_cf (general/gr_quadrature_demod_cf.cc:47-62) — FM
    discriminator via conjugate product + atan2 (history = 2).
  * gr_frequency_modulator_fc — phase integrator.
  * gr_single_pole_iir / gr_iir_filter_ffd — recursive filters.  A stable
    constant pole becomes a truncated FIR (the de-emphasis path): one launch
    of the ``iir1_fwd`` kernel on the card (:mod:`grtpu_torch.ops.cuda_iir`),
    a Toeplitz product on the CPU; slow poles use a log-depth scan written
    out in torch ops.
  * gri_control_loop — loop gains and phase wrapping for the carrier loops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from grtpu_torch.utils.device import resolve
from grtpu_torch.ops import cuda_iir
from grtpu_torch.ops.fir import (as_taps, fir_filter, pad_last, phase_advance,
                                 phase_ramp)


def _scalar_like(v, ref: torch.Tensor) -> torch.Tensor:
    """``v`` (tensor or number) as a tensor of ref's dtype on ref's device,
    without a host-to-device copy for plain numbers."""
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=ref.dtype)
    return torch.full((), float(v), dtype=ref.dtype, device=ref.device)


def _pow_series(a: float, start: int, n: int, device) -> torch.Tensor:
    """float32 [a**start, ..., a**(start+n-1)], computed in float64 on the
    device (no host-to-device copy)."""
    e = torch.arange(start, start + n, dtype=torch.float64, device=device)
    base = torch.full((n,), a, dtype=torch.float64, device=device)
    return base.pow(e).to(torch.float32)


# -------------------------------------------------------------------- rotator
def rotate(x: torch.Tensor, phase, phase_inc: float):
    """Multiply x by exp(j*(phase + i*phase_inc)); returns (y, new_phase).

    The phase ramp is float32 (grtpu's arithmetic, see
    :func:`grtpu_torch.ops.fir.phase_ramp`); the carried phase is wrapped
    each chunk."""
    n = x.shape[0]
    ph = phase_ramp(phase, phase_inc, n, x.device)
    y = x * torch.complex(torch.cos(ph), torch.sin(ph))
    return y.to(torch.complex64), phase_advance(phase, phase_inc * n, x.device)


def _phase_device(phase, device):
    if device is None and isinstance(phase, torch.Tensor):
        return phase.device
    return resolve(device)


def nco_sin(phase, phase_inc: float, n: int, device=None):
    """n samples of sin(phase + i*phase_inc) and the wrapped next phase, on
    ``phase``'s device when it is a tensor, else on ``device``."""
    dev = _phase_device(phase, device)
    ph = phase_ramp(phase, phase_inc, n, dev)
    return torch.sin(ph), phase_advance(phase, phase_inc * n, dev)


def nco_cos(phase, phase_inc: float, n: int, device=None):
    dev = _phase_device(phase, device)
    ph = phase_ramp(phase, phase_inc, n, dev)
    return torch.cos(ph), phase_advance(phase, phase_inc * n, dev)


def nco_exp(phase, phase_inc: float, n: int, device=None):
    dev = _phase_device(phase, device)
    ph = phase_ramp(phase, phase_inc, n, dev)
    return (torch.complex(torch.cos(ph), torch.sin(ph)),
            phase_advance(phase, phase_inc * n, dev))


def vco(freq: torch.Tensor, phase, sensitivity: float):
    """Voltage-controlled oscillator (gr_vco_f): phase integrates the input.

    Returns (cos(phi), new_phase)."""
    dphi = sensitivity * freq
    phi = _scalar_like(phase, dphi) + torch.cumsum(dphi, dim=0)
    return torch.cos(phi), torch.remainder(phi[-1], 2 * np.pi)


# -------------------------------------------------------- quadrature demod
# Minimax odd polynomial for atan(z) on [-1, 1] (degree 9), ~1.0e-5 rad.
_ATAN_C = (0.999866, -0.3302995, 0.180141, -0.085133, 0.0208351)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Branchless polynomial atan2 (gr_fast_atan2f analog), ~1e-5 rad.
    Returns 0 at (0, 0) like the reference."""
    ax, ay = x.abs(), y.abs()
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    z = mn / torch.where(mx == 0, torch.ones_like(mx), mx)
    z2 = z * z
    c = _ATAN_C
    p = torch.full_like(z, c[4])
    for k in (3, 2, 1, 0):
        p = p * z2 + c[k]
    a = p * z
    a = torch.where(ay > ax, (np.pi / 2) - a, a)
    a = torch.where(x < 0, np.pi - a, a)
    return torch.where(y < 0, -a, a).to(torch.float32)


def quadrature_demod(x: torch.Tensor, gain: float,
                     fast: bool = False) -> torch.Tensor:
    """FM discriminator (gr_quadrature_demod_cf.cc:47-62):
    out[i] = gain * arg(x[i+1] * conj(x[i])).

    Input carries 1 history sample (block history=2): length n+1 -> n
    outputs.  ``fast=True`` uses the polynomial :func:`fast_atan2`."""
    prod = x[..., 1:] * torch.conj(x[..., :-1])
    at2 = fast_atan2 if fast else torch.atan2
    return (gain * at2(prod.imag, prod.real)).to(torch.float32)


def frequency_modulator(x: torch.Tensor, phase, sensitivity: float):
    """gr_frequency_modulator_fc: out = exp(j * cumsum(sensitivity*x)).

    Returns (y, new_phase)."""
    dphi = sensitivity * x
    phi = _scalar_like(phase, dphi) + torch.cumsum(dphi, dim=0)
    y = torch.complex(torch.cos(phi), torch.sin(phi))
    return y, torch.remainder(phi[-1], 2 * np.pi).to(torch.float32)


def phase_modulator(x: torch.Tensor, sensitivity: float) -> torch.Tensor:
    """gr_phase_modulator_fc: out = exp(j * sensitivity * x)."""
    ph = sensitivity * x
    return torch.complex(torch.cos(ph), torch.sin(ph))


# ------------------------------------------------------------------- IIR
def linear_recurrence(a: torch.Tensor, b: torch.Tensor, y0):
    """Solve y[i] = a[i]*y[i-1] + b[i] with y[-1] = y0 along the last axis.

    The affine maps (a_i, b_i) compose associatively,
        (a2, b2) o (a1, b1) = (a2*a1, a2*b1 + b2),
    so the chunk solves in log2(n) Hillis-Steele steps of whole-tensor ops
    (the torch form of grtpu's ``lax.associative_scan``).  ``y0`` is a
    scalar or one value per leading row.  Returns (y, y_last)."""
    aa, bb = a, b
    n = b.shape[-1]
    s = 1
    while s < n:
        bb = torch.cat([bb[..., :s], aa[..., s:] * bb[..., :-s] + bb[..., s:]],
                       dim=-1)
        aa = torch.cat([aa[..., :s], aa[..., s:] * aa[..., :-s]], dim=-1)
        s *= 2
    y0 = _scalar_like(y0, b)
    y = aa * y0.unsqueeze(-1) + bb
    return y, y[..., -1]


def _slow_pole_chunked(aa: float, b: torch.Tensor, y0, L: int):
    """y[i] = aa*y[i-1] + b[i] via per-chunk closed form (see
    linear_recurrence_const's slow-pole branch): within a chunk of L,
        y[t] = a^{t+1} y0 + a^t * cumsum(b[k] a^{-k}),
    with only the chunk boundary carried sequentially.  Leading axes of
    ``b`` are batch axes."""
    n = b.shape[-1]
    lead = b.shape[:-1]
    bp = pad_last(b, 0, (-n) % L)
    nch = bp.shape[-1] // L
    apow = _pow_series(aa, 0, L, b.device)
    ainv = _pow_series(1.0 / aa, 0, L, b.device)

    sub = max(1, min(128, L))
    nsub = -(-L // sub)
    Lp = nsub * sub
    # two-level prefix sum: float32 cumsum error grows O(n * eps); the
    # blocked form keeps it O(sub * eps + nsub * eps)
    t = pad_last(bp.reshape(lead + (nch, L)) * ainv, 0, Lp - L)
    local = torch.cumsum(t.reshape(lead + (nch, nsub, sub)), dim=-1)
    blocks = torch.cumsum(local[..., -1], dim=-1)
    blocks = pad_last(blocks[..., :-1], 1, 0)
    s = (local + blocks.unsqueeze(-1)).reshape(lead + (nch, Lp))[..., :L] * apow
    coef = aa * apow
    carry = _scalar_like(y0, b).expand(lead)
    ys = []
    for c in range(nch):
        yc = coef * carry.unsqueeze(-1) + s[..., c, :]
        carry = yc[..., -1]
        ys.append(yc)
    y = torch.cat(ys, dim=-1)[..., :n]
    return y, y[..., n - 1]


def _pole_taps(aa: float, tol: float = 1e-9) -> int:
    """Taps of the truncated impulse response of a pole ``aa`` (|aa| < 1):
    past ceil(log(tol)/log|aa|) of them a^k is below ``tol``."""
    return int(np.ceil(np.log(tol) / np.log(max(abs(aa), 1e-12)))) \
        if aa != 0.0 else 1


# the most taps a pole's truncated response takes before the slow-pole paths
MAX_POLE_TAPS = 128

# (a, K, device) -> (a^0..a^(K-1), a^1..a^K): never evicted, because a
# captured CUDA graph holds the raw pointers of the ones it launched with
_POLE_SERIES = {}


def pole_series(aa: float, ntaps: int, device):
    """(a^0..a^(K-1), a^1..a^K) float32 on ``device``, by
    :func:`_pow_series` (so bit for bit what it makes), made once for each
    (a, K, device) and kept.  Made inside a CUDA-graph capture (a pole first
    seen there), they are made in the graph and not kept."""
    key = (aa, ntaps, torch.device(device))
    got = _POLE_SERIES.get(key)
    if got is None:
        got = (_pow_series(aa, 0, ntaps, device),
               _pow_series(aa, 1, ntaps, device))
        if not (got[0].is_cuda and torch.cuda.is_current_stream_capturing()):
            _POLE_SERIES[key] = got
    return got


def linear_recurrence_const(a: float, b: torch.Tensor, y0,
                            tol: float = 1e-9, max_taps: int = MAX_POLE_TAPS):
    """Solve y[i] = a*y[i-1] + b[i] for CONSTANT |a| < 1, exact to ``tol``.

    The impulse response a^k decays geometrically, so past
    n = ceil(log(tol)/log|a|) taps the recurrence IS a short FIR:
    y = conv(b, [1, a, a^2, ...]) + a^(i+1)*y0.  On a CUDA tensor (float32
    or complex64) that is one launch of ``iir1_fwd``
    (:mod:`grtpu_torch.ops.cuda_iir`); on a CPU tensor, its plain form, one
    Toeplitz matmul (:func:`truncated_plain`).  Slow poles (more than
    ``max_taps`` taps) use the scan (n <= 2^17) or the chunked closed form.
    b may be (..., n) batched on leading axes (y0 broadcasting along them).
    Returns (y, y_last)."""
    aa = float(a)
    if not (0.0 <= abs(aa) < 1.0):
        raise ValueError("linear_recurrence_const needs |a| < 1")
    ntaps = _pole_taps(aa, tol)
    if ntaps > max_taps:
        n_last = b.shape[-1]
        y0 = _scalar_like(y0, b).expand(b.shape[:-1])
        if n_last <= (1 << 17):
            return linear_recurrence(torch.full_like(b, aa), b, y0)
        L = int(np.clip(np.log(8.0) / max(-np.log(abs(aa)), 1e-12), 8, 4096))
        return _slow_pole_chunked(aa, b, y0, L)
    if b.device.type == "cuda":
        y, _ = cuda_iir.iir1_fwd(b, None, None, *pole_series(aa, ntaps,
                                                             b.device), y0)
    else:
        y = truncated_plain(aa, ntaps, b, y0)
    return y, y[..., -1]


def truncated_plain(aa: float, ntaps: int, b: torch.Tensor, y0):
    """The plain form of ``iir1_fwd``'s recurrence (what a CPU tensor runs):
    y[i] = sum_{k < ntaps} a^k b[i-k] + a^(i+1) y0 over b's last axis, as
    one Toeplitz product on any device."""
    # convolution taps: y[i] = sum_k taps[k] b[i-k] with taps[k] = a^k over
    # the zero-preloaded input
    taps = _pow_series(aa, 0, ntaps, b.device)
    n = b.shape[-1]
    y = fir_filter(pad_last(b, ntaps - 1, 0), taps, 1)
    # incoming-state correction: + a^(i+1) * y0 (negligible past ntaps)
    m = min(n, ntaps)
    corr = pad_last(_pow_series(aa, 1, m, b.device), 0, n - m)
    return y + _scalar_like(y0, b).unsqueeze(-1) * corr


def single_pole_iir(x: torch.Tensor, state, alpha: float):
    """y[i] = alpha*x[i] + (1-alpha)*y[i-1] (gri_single_pole_iir).
    Returns (y, new_state)."""
    return linear_recurrence_const(1.0 - float(alpha), alpha * x, state)


def iir_filter(x: torch.Tensor, state, fftaps, fbtaps):
    """Direct-form-I IIR (gr_iir_filter_ffd semantics):
    y[n] = sum_k ff[k] x[n-k] + sum_{k>=1} fb[k] y[n-k]
    (the reference stores feedback taps with implied positive sign).

    state: (x_hist[len(ff)-1], y_hist[len(fb)-1]) most-recent-last.
    ``fftaps`` may be a numpy array or a tensor; ``fbtaps`` is host data
    (numpy), so the first-order pole is read as a plain float.
    Returns (y, new_state)."""
    ff = as_taps(fftaps, x.device)
    fb_host = np.asarray(fbtaps, np.float32)
    nff, nfb = ff.shape[0], fb_host.shape[0]
    x_hist, y_hist = state
    if nfb == 2 and x.device.type == "cuda":
        # a fast stable pole: the feed-forward taps and the recurrence in
        # one launch of iir1_fwd
        a1 = float(fb_host[1])
        ntaps = _pole_taps(a1) if abs(a1) < 1.0 else None
        if ntaps is not None and ntaps <= MAX_POLE_TAPS:
            y, x_next = cuda_iir.iir1_fwd(
                x, x_hist if nff > 1 else None, ff,
                *pole_series(a1, ntaps, x.device), y_hist[-1])
            # an empty chunk leaves the state as it was
            return y, (x_hist if x_next is None else x_next,
                       y[-1:] if y.shape[-1] else y_hist)
    xs = torch.cat([x_hist, x]) if nff > 1 else x
    v = fir_filter(xs, ff, 1) if nff > 1 else x * ff[0]

    if nfb <= 1:
        y = v
        new_y_hist = y_hist
    elif nfb == 2:
        # first-order feedback (de-emphasis): a constant stable pole takes
        # the truncated-FIR solver
        a1 = float(fb_host[1])
        if 0.0 <= abs(a1) < 1.0:
            y, _ = linear_recurrence_const(a1, v, y_hist[-1])
        else:
            y, _ = linear_recurrence(torch.full_like(v, a1), v, y_hist[-1])
        new_y_hist = y[-1:][: nfb - 1]
    else:
        # general feedback: a sequential loop over samples (grtpu's lax.scan)
        fb_r = as_taps(fb_host[1:], x.device)
        carry = y_hist
        ys = []
        for i in range(v.shape[0]):
            yi = v[i] + torch.dot(torch.flip(carry, dims=(0,)), fb_r)
            carry = torch.cat([carry[1:], yi[None]])
            ys.append(yi)
        y = torch.stack(ys)
        new_y_hist = carry
    new_x_hist = xs[xs.shape[0] - (nff - 1):] if nff > 1 else x_hist
    return y, (new_x_hist, new_y_hist)


def iir_init_state(nff: int, nfb: int):
    return (torch.zeros((max(nff - 1, 0),), dtype=torch.float32),
            torch.zeros((max(nfb - 1, 0),), dtype=torch.float32))


# ------------------------------------------------------------- control loop
def control_loop_gains(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0):
    """2nd-order PI loop alpha/beta from bandwidth & damping
    (gri_control_loop.cc:34-46).  Host floats."""
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4 * damping * loop_bw) / denom
    beta = (4 * loop_bw * loop_bw) / denom
    return alpha, beta


def phase_wrap(phase: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi] (gri_control_loop::phase_wrap); floored modulo,
    as ``jnp.mod``."""
    return torch.remainder(phase + np.pi, 2 * np.pi) - np.pi


# ----------------------------------------------------------------- dc block
def dc_blocker(x: torch.Tensor, state: torch.Tensor, length: int):
    """gr_dc_blocker_ff, single moving-average form:
    y[i] = x[i - (D-1)//2] - MA_D(x)[i]; ``state`` carries the needed history
    (``(D-1) + (D-1)//2`` samples).  Returns (y, new_state)."""
    d = length
    xs = torch.cat([state, x])
    c = torch.cumsum(xs.to(torch.float32), dim=0)
    c = pad_last(c, 1, 0)
    ma = (c[d:] - c[:-d]) / d  # MA over trailing window, len(xs)-d+1 values
    n = x.shape[0]
    half = (d - 1) // 2
    delayed = xs[xs.shape[0] - n - half: xs.shape[0] - half]
    y = delayed - ma[ma.shape[0] - n:]
    new_hist = xs[xs.shape[0] - (d - 1) - half:]
    return y.to(x.dtype), new_hist
