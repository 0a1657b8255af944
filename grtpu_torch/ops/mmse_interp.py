"""MMSE fractional-delay interpolator bank, in PyTorch.

Port of ``grtpu.ops.mmse_interp``.  Analog of gri_mmse_fir_interpolator(_cc)
(gnuradio-core/src/lib/filter/gri_mmse_fir_interpolator.{cc,h},
interpolator_taps.h:7-9): an 8-tap, 128(+1)-phase filter bank giving samples
at fractional delays, used by clock recovery and fractional resampling.

The bank is grtpu's, designed by least-squares fractional-delay fitting
(minimize passband error vs the ideal delay response over [0, 0.8*pi]) in
numpy, so both packages hold the identical float32 table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NTAPS = 8
NSTEPS = 128
_CENTER = NTAPS // 2 - 1  # integer part of the nominal delay (=3)
_BAND = 0.8 * np.pi  # passband edge for the LS fit


@functools.lru_cache(maxsize=1)
def _mmse_table() -> np.ndarray:
    """(NSTEPS+1, NTAPS) least-squares fractional-delay filters.

    Phase p approximates delay d = _CENTER + p/NSTEPS:
        h_p = argmin ∫_0^B |Σ_k h[k] e^{-jwk} - e^{-jwd}|^2 dw
    whose normal equations have closed-form sinc integrals."""
    W = _BAND

    def sint(a):  # ∫_0^W cos(w*a) dw = sin(W*a)/a  (-> W as a -> 0)
        a = np.asarray(a, np.float64)
        out = np.where(np.abs(a) < 1e-12, W, np.sin(W * a) / np.where(a == 0, 1, a))
        return out

    k = np.arange(NTAPS)
    A = sint(k[:, None] - k[None, :])
    bank = np.zeros((NSTEPS + 1, NTAPS), np.float64)
    for p in range(NSTEPS + 1):
        d = _CENTER + p / NSTEPS
        b = sint(k - d)
        bank[p] = np.linalg.solve(A, b)
    return bank.astype(np.float32)


def mmse_taps() -> np.ndarray:
    return _mmse_table()


def bank_on(device) -> torch.Tensor:
    """The (NSTEPS+1, NTAPS) bank as a float32 tensor on ``device``, copied
    once per device (each clock-recovery call asks for it)."""
    return _bank_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def _bank_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mmse_table()).to(device)


def mmse_interpolate(x: torch.Tensor, pos: torch.Tensor,
                     bank: torch.Tensor | None = None) -> torch.Tensor:
    """Sample x at fractional positions.

    pos[i] = continuous-time position (in input samples); uses
    x[floor(pos) .. floor(pos)+7] with the phase filter nearest to
    frac(pos).  Caller guarantees floor(pos)+7 < len(x)."""
    if bank is None:
        bank = bank_on(x.device)
    base = torch.floor(pos)
    mu = pos - base
    phase = torch.round(mu * NSTEPS).long()
    idx = base.long()[:, None] + torch.arange(NTAPS, device=x.device)[None, :]
    windows = x[idx]                                   # (n, 8) gather
    taps = bank[phase]                                 # (n, 8)
    return (windows * taps).sum(dim=1).to(x.dtype)


def _fused_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[k] * b[k] from 0 in order, each product fused into the
    running float32 sum: exact in float64, one rounding per term."""
    p = a.double() * b.double()
    acc = p[..., 0].float()
    for k in range(1, p.shape[-1]):
        acc = (acc.double() + p[..., k]).float()
    return acc


def _ordered_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[k] * b[k] from 0 in order, rounding each product."""
    p = a * b
    acc = p[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc + p[..., k]
    return acc


def scan_dot(x_window: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """sum_k x_window[k] * taps[k] (real taps) as XLA's CPU backend sums it
    for grtpu inside a scan: in order, each product fused into the running
    sum — except the real part of a complex window, whose products are
    rounded first.  The sum runs over the last axis; leading axes are batch
    axes (each row summed as a window alone would be)."""
    if x_window.is_complex():
        return torch.complex(_ordered_dot(x_window.real, taps),
                             _fused_dot(x_window.imag, taps))
    return _fused_dot(x_window, taps)


def interpolate_point(x_window: torch.Tensor, mu: torch.Tensor,
                      bank: torch.Tensor) -> torch.Tensor:
    """Single-point interpolation from an 8-sample window (the step of the
    clock-recovery recurrences).  mu in [0, 1], a 0-d tensor: the phase is
    picked on the device, with no host read.

    The 8-term dot is summed in grtpu's order (:func:`scan_dot`).  Both
    packages then pick the same interpolator phase on the next symbol, where
    a last-bit difference could flip it."""
    taps = torch.index_select(bank, 0, torch.round(mu * NSTEPS).long().reshape(1))[0]
    return scan_dot(x_window, taps)
