"""Optimal (Parks-McClellan) FIR design.

Analog of gnuradio-core/src/python/gnuradio/optfir.py and gr_remez
(SURVEY.md §2.4 tap design): equiripple low/high/band pass + complex
band pass, with the reference's automatic order estimate (Herrmann/Rabiner)
and passband/stopband ripple specified in linear/dB terms.

The exchange-algorithm engine is grtpu_torch.utils.remez_engine — a
self-contained Parks-McClellan implementation (no scipy on the tap-design
path), verified against scipy.signal.remez in tests.
"""

from __future__ import annotations

import math

import numpy as np

from grtpu_torch.utils.remez_engine import design as _remez_design
from grtpu_torch.utils.remez_engine import pm_remez  # noqa: F401  (gr.remez API)


def remez(numtaps, bands, desired, weight=None, fs=1.0):
    """scipy-flavored surface over the own Parks-McClellan engine:
    one desired amplitude per band, band edges in Hz at fs."""
    b = np.asarray(bands, np.float64) / fs
    return _remez_design(numtaps, b, desired, weight).astype(np.float32)


# ------------------------- order estimate (optfir.remezord equivalents) ----
def _lporder(freq1: float, freq2: float, delta_p: float, delta_s: float):
    """Herrmann-Rabiner low-pass order estimate (optfir.lporder)."""
    df = abs(freq2 - freq1)
    ddp = math.log10(delta_p)
    dds = math.log10(delta_s)
    a1, a2, a3 = 5.309e-3, 7.114e-2, -4.761e-1
    a4, a5, a6 = -2.66e-3, -5.941e-1, -4.278e-1
    t1 = a1 * ddp * ddp + a2 * ddp + a3
    t2 = a4 * ddp * ddp + a5 * ddp + a6
    dinf = dds * t1 + t2
    ff = 11.01217 + 0.51244 * (ddp - dds)
    n = dinf / df - ff * df + 1
    return n


def passband_ripple_to_dev(ripple_db: float) -> float:
    return (10 ** (ripple_db / 20) - 1) / (10 ** (ripple_db / 20) + 1)


def stopband_atten_to_dev(atten_db: float) -> float:
    return 10 ** (-atten_db / 20)


def low_pass(gain, Fs, freq1, freq2, passband_ripple_db, stopband_atten_db,
             nextra_taps: int = 2) -> np.ndarray:
    """optfir.low_pass: equiripple LPF from band edges + ripple specs."""
    passband_dev = passband_ripple_to_dev(passband_ripple_db)
    stopband_dev = stopband_atten_to_dev(stopband_atten_db)
    n = int(math.ceil(_lporder(freq1 / Fs, freq2 / Fs,
                               passband_dev, stopband_dev))) + nextra_taps
    n |= 1
    taps = remez(n, [0, freq1, freq2, 0.5 * Fs], [gain, 0],
                 weight=[stopband_dev / passband_dev, 1.0], fs=Fs)
    return taps


def high_pass(gain, Fs, freq1, freq2, passband_ripple_db, stopband_atten_db,
              nextra_taps: int = 2) -> np.ndarray:
    passband_dev = passband_ripple_to_dev(passband_ripple_db)
    stopband_dev = stopband_atten_to_dev(stopband_atten_db)
    n = int(math.ceil(_lporder(freq1 / Fs, freq2 / Fs,
                               passband_dev, stopband_dev))) + nextra_taps
    n |= 1
    taps = remez(n, [0, freq1, freq2, 0.5 * Fs], [0, gain],
                 weight=[1.0, stopband_dev / passband_dev], fs=Fs)
    return taps


def band_pass(gain, Fs, freq_sb1, freq_pb1, freq_pb2, freq_sb2,
              passband_ripple_db, stopband_atten_db,
              nextra_taps: int = 2) -> np.ndarray:
    """optfir.band_pass."""
    passband_dev = passband_ripple_to_dev(passband_ripple_db)
    stopband_dev = stopband_atten_to_dev(stopband_atten_db)
    n = int(math.ceil(_lporder(freq_sb1 / Fs, freq_pb1 / Fs,
                               passband_dev, stopband_dev))) + nextra_taps
    n |= 1
    w = stopband_dev / passband_dev
    taps = remez(n, [0, freq_sb1, freq_pb1, freq_pb2, freq_sb2, 0.5 * Fs],
                 [0, gain, 0], weight=[w, 1.0, w], fs=Fs)
    return taps


def complex_band_pass(gain, Fs, freq_sb1, freq_pb1, freq_pb2, freq_sb2,
                      passband_ripple_db, stopband_atten_db) -> np.ndarray:
    """optfir.complex_band_pass: LP prototype rotated to the band center."""
    center = 0.5 * (freq_pb1 + freq_pb2)
    lp = low_pass(gain, Fs, (freq_pb2 - freq_pb1) / 2,
                  (freq_sb2 - freq_sb1) / 2, passband_ripple_db,
                  stopband_atten_db)
    n = np.arange(len(lp)) - (len(lp) - 1) // 2
    return (lp * np.exp(2j * np.pi * center / Fs * n)).astype(np.complex64)
