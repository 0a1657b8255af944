"""Filter designs of the configurations, worked out in float64 NumPy from
their published formulas.  The references and the signal generators use
these; nothing here reads a table or a tap set that the program made.

- ``low_pass``: GNU Radio's ``gr_firdes::low_pass`` with the Hamming window
  (53 dB, ``ntaps = int(53 fs / (22 tw))`` forced odd, DC gain 1).
- ``rrc``: the root-raised-cosine pulse at unit energy times ``gain`` (the
  normalisation the DMR configuration states), ``ntaps`` forced odd.
- ``mmse_bank``: the clock recovery's 8-tap, 129-phase fractional-delay
  bank, each phase the least-squares fit of a delay of ``3 + p / 128``
  samples over the band [0, 0.8 pi].
- ``deemphasis``: the bilinear single pole of ``fm_deemph`` (tau 75 us).
"""

from __future__ import annotations

import math

import numpy as np

HAMMING_DB = 53.0


def low_pass(gain: float, fs: float, cutoff: float, transition: float) -> np.ndarray:
    ntaps = int(HAMMING_DB * fs / (22.0 * transition))
    ntaps |= 1
    m = (ntaps - 1) // 2
    n = np.arange(ntaps)
    w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (ntaps - 1))
    fwt0 = 2 * np.pi * cutoff / fs
    k = n - m
    h = np.where(k == 0, fwt0 / np.pi,
                 np.sin(k * fwt0) / (np.pi * np.where(k == 0, 1, k))) * w
    return h * (gain / h.sum())


def rrc(gain: float, fs: float, symbol_rate: float, alpha: float,
        ntaps: int) -> np.ndarray:
    ntaps |= 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / (fs / symbol_rate)
    h = np.empty(ntaps)
    for i, ti in enumerate(t):
        if ti == 0:
            h[i] = 1 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1) < 1e-8:
            h[i] = alpha / np.sqrt(2) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            h[i] = ((np.sin(np.pi * ti * (1 - alpha))
                     + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha)))
                    / (np.pi * ti * (1 - (4 * alpha * ti) ** 2)))
    return h * gain / np.sqrt((h ** 2).sum())


def mmse_bank(ntaps: int = 8, nsteps: int = 128, band: float = 0.8 * np.pi) -> np.ndarray:
    """(nsteps + 1, ntaps): row p minimises the integral over [0, band] of
    |sum_k h[k] e^{-jwk} - e^{-jwd}|^2, d = ntaps / 2 - 1 + p / nsteps."""
    def integral(a):  # integral over [0, band] of cos(w a) dw
        a = np.asarray(a, np.float64)
        safe = np.where(np.abs(a) < 1e-12, 1.0, a)
        return np.where(np.abs(a) < 1e-12, band, np.sin(band * a) / safe)

    k = np.arange(ntaps)
    gram = integral(k[:, None] - k[None, :])
    centre = ntaps // 2 - 1
    return np.stack([np.linalg.solve(gram, integral(k - (centre + p / nsteps)))
                     for p in range(nsteps + 1)])


def deemphasis(fs: float, tau: float):
    """(b0, p1): y[n] = b0 (x[n] + x[n-1]) + p1 y[n-1]."""
    k = math.tan(1.0 / (2.0 * fs * tau))
    return k / (1 + k), (1 - k) / (1 + k)
