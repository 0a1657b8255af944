"""Polyphase filterbank ops: channelizer, synthesizer, arbitrary resampler
(port of ``grtpu.ops.pfb``).

Analogs:
  * gr_pfb_channelizer_ccf (gnuradio-core/src/lib/filter/
    gr_pfb_channelizer_ccf.cc:44-200): N-way commutated polyphase FIR +
    N-point transform splitting one wideband stream into N channels.
  * gr_pfb_synthesis_filterbank_ccf: the inverse.
  * gr_pfb_arb_resampler_ccf (gr_pfb_arb_resampler_ccf.cc:42-209):
    filter-size-phase bank + derivative bank, accumulator-stepped arbitrary
    rate with linear interpolation between adjacent phases.
  * gr_pfb_decimator_ccf / gr_pfb_interpolator_ccf.

The mathematics is grtpu's: no commutator loop — the polyphase decomposition
is a reshape/stride pattern, and the per-branch FIRs and the transform
across branches fold into real float32 matmuls.  The arbitrary resampler has
*no feedback*: every output's (input index, phase, fraction) is a
closed-form function of the rational rate, so the whole resample is one
strided window matrix times one block-Toeplitz tap matrix.

Every real product goes through :func:`grtpu_torch.ops.fir.real_matmul`,
so ``precision`` means what it means for the FIR ops ("f32" refuses TF32 on
the card; "bf16x3" is the same three passes; "bf16" one pass on
bf16-rounded operands).  The constant matrices are built once per
(taps, shape, device) and kept on the device.

Channel convention: channel c of ``channelize`` is centered at +c*fs/N
(wrapping: c > N/2 are negative frequencies), output rate fs/N:

    y_c[t] = sum_m h[m] x[tN - m] e^{-2i pi c m / N}
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from grtpu_torch.ops.fir import (PRECISIONS, _matmul, _window_matrix, pad_last,
                                 real_matmul)
from grtpu_torch.utils import firdes


def polyphase_taps(proto: np.ndarray, nphases: int) -> np.ndarray:
    """(nphases, kp) bank: phase p = proto[p::nphases], zero-padded."""
    k = len(proto)
    kp = -(-k // nphases)
    tp = np.zeros(nphases * kp, proto.dtype)
    tp[:k] = proto
    return tp.reshape(kp, nphases).T.copy()


def _derivative_taps(proto: np.ndarray) -> np.ndarray:
    """First difference of the prototype (the derivative filter of the
    arbitrary resampler and the clock sync)."""
    dproto = np.empty_like(proto)
    dproto[:-1] = proto[1:] - proto[:-1]
    dproto[-1] = 0
    return dproto


def _planes(m: np.ndarray, device):
    """(real, imag) float32 tensors of a complex host matrix."""
    m = m.astype(np.complex64)
    return (torch.from_numpy(np.ascontiguousarray(m.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(m.imag)).to(device))


def _cmm(a: torch.Tensor, m_re: torch.Tensor, m_im: torch.Tensor,
         precision: str) -> torch.Tensor:
    """Complex matmul from real float32 products; ``a`` may be real."""
    def rmm(p, q):
        return real_matmul(p.contiguous(), q, precision)

    if a.is_complex():
        ar, ai = a.real, a.imag
        return torch.complex(rmm(ar, m_re) - rmm(ai, m_im),
                             rmm(ar, m_im) + rmm(ai, m_re))
    return torch.complex(rmm(a, m_re), rmm(a, m_im))


@functools.lru_cache(maxsize=32)
def _channelizer_mats(taps_bytes: bytes, taps_dtype: str, N: int, os_: int,
                      device: torch.device):
    """The constant matrices of :func:`channelize` on ``device``:
    ``(kp, [(M_re, M_im), ...], perm)``."""
    proto = np.frombuffer(taps_bytes, dtype=taps_dtype)
    bank = polyphase_taps(proto, N)                       # (N, kp)
    kp = bank.shape[1]
    dft = np.exp(2j * np.pi * np.outer(np.arange(N), np.arange(N)) / N)
    step = N // os_
    perm = torch.from_numpy(
        np.array([(step - s) % step for s in range(step)])).to(device)
    if os_ == 1:
        # M_j[b, c] = h[jN + b] * e^{2i pi b c / N}  (IDFT * N)
        mats = [_planes(bank[:, j][:, None] * dft, device) for j in range(kp)]
        return kp, mats, perm
    rows = []
    for j in range(kp):
        for q in range(os_):
            b_rows = q * step + np.arange(step)          # branches in slice
            rows.append((bank[b_rows, j][:, None]
                         * dft[b_rows, :]).astype(np.complex64))  # (step, N)
    return kp, [_planes(np.concatenate(rows, axis=0), device)], perm


def channelize(x: torch.Tensor, proto_taps: np.ndarray, nchan: int,
               oversample: int = 1, precision: str = "f32") -> torch.Tensor:
    """Polyphase channelizer; see module docstring.

    ``precision`` (honored by both the critically-sampled and the
    oversampled path): "f32" (exact float32 matmuls), "bf16x3" (split-word
    3-pass) or "bf16" (single pass on bf16-rounded operands, about 48-53 dB
    — for chains whose demods lock far below that floor).

    Args:
      x: input with ``kp * nchan`` history samples (kp = ceil(K/N) taps per
         branch): length n + kp*nchan, n % nchan == 0.
      proto_taps: prototype lowpass at input rate, cutoff ~fs/(2N).
      oversample: per-channel output rate multiplier (the reference's
        filter-index-rotation oversampling, gr_pfb_channelizer_ccf.cc:44-200,
        realized here as a stride-N/os commutator + per-step phase twist);
        must divide nchan.

    Returns (oversample * n // nchan, nchan) complex64, time-major; channel
    c at +c*fs/N, output rate oversample*fs/N.
    """
    N = nchan
    os_ = oversample
    if N % os_:
        raise ValueError("oversample must divide nchan")
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be 'f32', 'bf16' or 'bf16x3', got {precision!r}")
    step = N // os_
    proto = np.ascontiguousarray(proto_taps)
    kp, mats, perm = _channelizer_mats(proto.tobytes(), proto.dtype.str, N,
                                       os_, x.device)
    hist = kp * N
    n = x.shape[0] - hist
    T = (n // N) * os_

    # v[b,t] = sum_j bank[b,j] x[hist + t*step - j*N - b]
    # (the commutator advances `step` inputs per output row; the branch FIR
    # strides N regardless of oversampling)
    if os_ == 1:
        # reshape x into rows of N, so
        # x[hist + (t-j)N - b] = X2[t - j + kp - 1 + (b==0), (N-b) % N];
        # stage tap j is a ROW-SHIFTED slice of the column-permuted matrix,
        # and the branch FIR + N-point IDFT fold into one (T,N)@(N,N)
        # complex matmul per tap:  y += blk_j @ M_j.
        rows = T + kp
        P = x[:rows * N].reshape(rows, N)[:, perm]  # P[m, b] = x[mN + (N-b)%N]
        acc = None
        for j in range(kp):
            # column 0 (branch 0) reads one row later than the others
            blk = torch.cat([P[kp - j:kp - j + T, :1],
                             P[kp - 1 - j:kp - 1 - j + T, 1:]], dim=1)
            term = _cmm(blk, *mats[j], precision)
            acc = term if acc is None else acc + term
        return acc.to(torch.complex64)  # (T, N), channel c at +c*fs/N

    # oversampled: the same row-shift trick generalized to the step = N/os
    # commutator.  Write branch b = q*step + s; then v[b, t] needs
    # x[hist + (t - j*os - q)*step - s], i.e. a row-shifted slice (shift
    # g = j*os + q in [0, kp*os)) of the column-permuted step-wide reshape.
    # The shifted windows concatenate along the contraction axis and the
    # per-shift weight matrices along rows: ONE (T, G*step)@(G*step, N)
    # matmul carries the whole branch FIR + IDFT + per-branch weighting.
    G = kp * os_
    rows = T + G
    P = x[:rows * step].reshape(rows, step)[:, perm]
    blocks = []
    for g in range(G):
        blocks.append(P[G - g:G - g + T, :1])
        blocks.append(P[G - 1 - g:G - 1 - g + T, 1:])
    W = torch.cat(blocks, dim=1)                         # (T, G*step)
    acc = _cmm(W, *mats[0], precision)
    # channel c's downconversion phase at output t is -2pi c (t*step)/N =
    # -2pi (t c)/os — periodic in (t c) mod os, so reduce BEFORE the float
    # multiply (t*c leaves float32's integer range past 2^24 samples)
    tc = (torch.arange(T, device=x.device)[:, None] % os_) \
        * (torch.arange(N, device=x.device)[None, :] % os_) % os_
    ang = (-2 * np.pi) * tc.to(torch.float32) / os_
    tw = torch.complex(torch.cos(ang), torch.sin(ang))
    return (acc * tw).to(torch.complex64)


@functools.lru_cache(maxsize=32)
def _synth_bank(taps_bytes: bytes, taps_dtype: str, N: int,
                device: torch.device) -> torch.Tensor:
    """The synthesizer's (N, kp) polyphase bank, each row reversed, on
    ``device``."""
    bank = polyphase_taps(np.frombuffer(taps_bytes, dtype=taps_dtype), N)
    return torch.from_numpy(bank[:, ::-1].copy()).to(device)


def synthesize(chans: torch.Tensor, proto_taps: np.ndarray) -> torch.Tensor:
    """Polyphase synthesis filterbank: (T + kp - 1, N) channel matrix (with
    kp-1 history rows) -> (T*N,) stream.

    x_rec[tN + p] = sum_j bank[p, j] * (N * IFFT_N(chans[t - j]))[p]
    — the inverse of :func:`channelize` up to the prototype response and
    kp*N/2-ish group delay.
    """
    T_in, N = chans.shape
    proto = np.ascontiguousarray(proto_taps)
    bk = _synth_bank(proto.tobytes(), proto.dtype.str, N, chans.device)
    kp = bk.shape[1]
    T = T_in - (kp - 1)
    v = torch.fft.ifft(chans, dim=1).T * N  # (N, T_in) branch streams
    # s[p, t] = sum_j bk[p, j] v[p, t + j]: kp shifted multiply-adds (the
    # sum grtpu takes over a gathered (N, T, kp) window)
    s = None
    for j in range(kp):
        term = v[:, j:j + T] * bk[:, j, None]
        s = term if s is None else s + term
    # interpolation-by-N needs prototype gain N (each branch sees 1/N of
    # the unity-DC prototype)
    return (N * s.T.reshape(-1)).to(torch.complex64)  # out[t*N+p] = s[p,t]


def design_channelizer_taps(nchan: int, taps_per_branch: int = 12) -> np.ndarray:
    """Prototype lowpass for an N-channel bank (pfb_channelizer helper:
    cutoff at half the channel width, designed at the input rate)."""
    ntaps = nchan * taps_per_branch
    return firdes.low_pass_2(1.0, nchan, 0.5, ntaps,
                             firdes.Window.BLACKMAN_HARRIS)


# ------------------------------------------------------------ arb resampler
def arb_resampler_plan(rate: Fraction, n_in: int,
                       filter_size: int) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, int]:
    """Static (input index, phase, frac) tables for one chunk.

    Output k samples continuous input position p_k = k / rate;
    phase = frac(p_k) * filter_size, linear interpolation between adjacent
    phases — the reference's accumulator recurrence in closed form."""
    n_out = int(n_in * rate)
    k = np.arange(n_out, dtype=np.float64)
    p = k / float(rate)
    i = np.floor(p).astype(np.int64)
    mu = p - i
    phf = mu * filter_size
    ph = np.floor(phf).astype(np.int64)
    frac = (phf - ph).astype(np.float32)
    return i, ph, frac, n_out


@functools.lru_cache(maxsize=32)
def _arb_plan(taps_bytes: bytes, taps_dtype: str, rate: Fraction, n: int,
              filter_size: int, device: torch.device):
    """Shapes and the block-Toeplitz tap matrix of :func:`arb_resample` for
    an n-sample chunk: ``(kp, n_out, G, S, span_g, M, need, T)``."""
    proto = np.frombuffer(taps_bytes, dtype=taps_dtype)
    bank = polyphase_taps(proto, filter_size)           # (M, kp)
    dbank = polyphase_taps(_derivative_taps(proto), filter_size)
    kp = bank.shape[1]
    i, ph, frac, n_out = arb_resampler_plan(rate, n, filter_size)
    bank_r = bank[:, ::-1].copy()
    dbank_r = dbank[:, ::-1].copy()
    # Outputs k = r (mod P) share the same (phase, frac) and advance Q input
    # samples per period.  G periods are grouped per matmul row so the
    # output axis is at least 128 columns wide even at tiny P.  T is
    # block-Toeplitz: column g*P + r holds residue r's interpolated taps
    # shifted down g*Q rows.
    P, Q = rate.numerator, rate.denominator
    span = int(i[P - 1]) + kp if n_out >= P else int(i[-1]) + kp
    G = max(1, -(-128 // P)) if n_out >= P else 1
    while G > 1 and (G - 1) * Q + span > 2048:   # cap row width
        G -= 1
    S = G * Q                                    # input stride per row
    span_g = (G - 1) * Q + span                  # window columns per row
    M = -(-n_out // (G * P))
    need = (M - 1) * S + span_g
    T = np.zeros((span_g, G * P), np.float32)
    for r in range(min(P, n_out)):
        ir, phr, fr = int(i[r]), int(ph[r]), float(frac[r])
        col = bank_r[phr] + fr * dbank_r[phr]
        for g in range(G):
            T[ir + g * Q: ir + g * Q + kp, g * P + r] = col
    return kp, n_out, S, span_g, M, need, torch.from_numpy(T).to(device)


def arb_resample(x: torch.Tensor, proto_taps: np.ndarray, rate: Fraction,
                 filter_size: int = 32,
                 precision: str = "f32") -> torch.Tensor:
    """Arbitrary-rate polyphase resampler (gr_pfb_arb_resampler semantics).

    x carries kp-1 history samples (kp = taps per phase) on its last axis;
    leading axes are batch axes.  Output length = n * rate (n * rate must
    be integral).  ``precision`` is the matmul mode (grtpu reads it from its
    FIR module's global setting).
    """
    proto = np.ascontiguousarray(proto_taps)
    kp = -(-len(proto) // filter_size)
    n = x.shape[-1] - (kp - 1)
    kp, n_out, S, span_g, M, need, T = _arb_plan(
        proto.tobytes(), proto.dtype.str, Fraction(rate), n, filter_size,
        x.device)
    if x.shape[-1] < need:
        x = pad_last(x, 0, need - x.shape[-1])
    # W is a strided window matrix built from reshape slices
    if span_g > S:
        W = _window_matrix(x[..., :need], span_g - S + 1, S)  # (M, span_g)
    else:  # rows don't overlap (decimating rates with short taps)
        xp = pad_last(x[..., :need], 0, M * S - need)
        W = xp.reshape(x.shape[:-1] + (M, S))[..., :span_g]
    y = _matmul(W, T, precision).reshape(x.shape[:-1] + (-1,))[..., :n_out]
    return y.to(x.dtype)


def design_arb_resampler_taps(rate: float, filter_size: int = 32) -> np.ndarray:
    """Prototype for the arb resampler (blks2impl/pfb_arb_resampler design):
    lowpass at the narrower of input/output Nyquist, designed at
    filter_size x the input rate."""
    cutoff = 0.45 * min(1.0, float(rate))  # cycles/input-sample
    transition = 0.1 * min(1.0, float(rate))
    return firdes.low_pass(filter_size, filter_size, cutoff, transition,
                           firdes.Window.BLACKMAN_HARRIS)
