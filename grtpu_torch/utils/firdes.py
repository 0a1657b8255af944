"""FIR tap design — windowed-sinc and pulse-shaping designs.

API-parity analog of gr_firdes (gnuradio-core/src/lib/general/gr_firdes.h:39-367)
written from DSP first principles: low/high/band pass, band reject,
complex band pass, root-raised-cosine, Gaussian, Hilbert, plus the window
function family (gnuradio-core/src/python/gnuradio/window.py analog).

All functions return float32/complex64 numpy arrays (taps are host-side
constants baked into jitted programs).
"""

from __future__ import annotations

import math
from enum import IntEnum

import numpy as np


class Window(IntEnum):
    """gr_firdes::win_type analog."""

    HAMMING = 0
    HANN = 1
    BLACKMAN = 2
    RECTANGULAR = 3
    KAISER = 4
    BLACKMAN_HARRIS = 5
    BARTLETT = 6
    FLATTOP = 7


WIN_HAMMING = Window.HAMMING
WIN_HANN = Window.HANN
WIN_BLACKMAN = Window.BLACKMAN
WIN_RECTANGULAR = Window.RECTANGULAR
WIN_KAISER = Window.KAISER
WIN_BLACKMAN_HARRIS = Window.BLACKMAN_HARRIS


def window(win_type: Window, ntaps: int, beta: float = 6.76) -> np.ndarray:
    """Return the window coefficients (gr_firdes::window analog)."""
    n = np.arange(ntaps)
    m = ntaps - 1
    if win_type == Window.RECTANGULAR:
        w = np.ones(ntaps)
    elif win_type == Window.HAMMING:
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / m)
    elif win_type == Window.HANN:
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / m)
    elif win_type == Window.BLACKMAN:
        w = 0.42 - 0.5 * np.cos(2 * np.pi * n / m) + 0.08 * np.cos(4 * np.pi * n / m)
    elif win_type == Window.BLACKMAN_HARRIS:
        w = (0.35875 - 0.48829 * np.cos(2 * np.pi * n / m)
             + 0.14128 * np.cos(4 * np.pi * n / m)
             - 0.01168 * np.cos(6 * np.pi * n / m))
    elif win_type == Window.BARTLETT:
        w = 1.0 - np.abs(2 * n / m - 1.0)
    elif win_type == Window.FLATTOP:
        a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
        w = (a[0] - a[1] * np.cos(2 * np.pi * n / m)
             + a[2] * np.cos(4 * np.pi * n / m)
             - a[3] * np.cos(6 * np.pi * n / m)
             + a[4] * np.cos(8 * np.pi * n / m))
    elif win_type == Window.KAISER:
        w = np.i0(beta * np.sqrt(1 - (2 * n / m - 1) ** 2)) / np.i0(beta)
    else:
        raise ValueError(f"unknown window type {win_type}")
    return w.astype(np.float64)


def _max_attenuation(win_type: Window, beta: float) -> float:
    """Stop-band attenuation used for automatic tap-count estimation."""
    return {
        Window.HAMMING: 53.0,
        Window.HANN: 44.0,
        Window.BLACKMAN: 74.0,
        Window.RECTANGULAR: 21.0,
        Window.KAISER: beta / 0.1102 + 8.7,
        Window.BLACKMAN_HARRIS: 92.0,
        Window.BARTLETT: 27.0,
        Window.FLATTOP: 93.0,
    }[win_type]


def compute_ntaps(sampling_freq: float, transition_width: float,
                  win_type: Window = Window.HAMMING, beta: float = 6.76) -> int:
    """Tap count from transition width (gr_firdes::compute_ntaps rule:
    ntaps ~= attenuation_dB / (22 * normalized transition width), forced odd).
    """
    a = _max_attenuation(win_type, beta)
    ntaps = int(a * sampling_freq / (22.0 * transition_width))
    if (ntaps & 1) == 0:
        ntaps += 1
    return ntaps


def _sanity(sampling_freq, fa, transition_width):
    if sampling_freq <= 0:
        raise ValueError("sampling_freq must be > 0")
    if fa <= 0 or fa > sampling_freq / 2:
        raise ValueError("cutoff must be in (0, fs/2]")
    if transition_width <= 0:
        raise ValueError("transition_width must be > 0")


def low_pass(gain: float, sampling_freq: float, cutoff_freq: float,
             transition_width: float, win_type: Window = Window.HAMMING,
             beta: float = 6.76) -> np.ndarray:
    """Windowed-sinc low-pass (gr_firdes::low_pass)."""
    _sanity(sampling_freq, cutoff_freq, transition_width)
    ntaps = compute_ntaps(sampling_freq, transition_width, win_type, beta)
    return low_pass_2(gain, sampling_freq, cutoff_freq, ntaps, win_type, beta)


def low_pass_2(gain, sampling_freq, cutoff_freq, ntaps,
               win_type: Window = Window.HAMMING, beta: float = 6.76):
    w = window(win_type, ntaps, beta)
    m = (ntaps - 1) // 2
    fwt0 = 2 * np.pi * cutoff_freq / sampling_freq
    n = np.arange(ntaps) - m
    nz = np.where(n == 0, 1, n)
    taps = np.where(n == 0, fwt0 / np.pi, np.sin(n * fwt0) / (nz * np.pi)) * w
    # normalize DC gain
    taps = taps * (gain / taps.sum())
    return taps.astype(np.float32)


def high_pass(gain, sampling_freq, cutoff_freq, transition_width,
              win_type: Window = Window.HAMMING, beta: float = 6.76):
    """Windowed-sinc high-pass, unity gain at Nyquist (gr_firdes::high_pass)."""
    _sanity(sampling_freq, cutoff_freq, transition_width)
    ntaps = compute_ntaps(sampling_freq, transition_width, win_type, beta)
    w = window(win_type, ntaps, beta)
    m = (ntaps - 1) // 2
    fwt0 = 2 * np.pi * cutoff_freq / sampling_freq
    n = np.arange(ntaps) - m
    nz = np.where(n == 0, 1, n)
    taps = np.where(n == 0, 1.0 - fwt0 / np.pi,
                    -np.sin(n * fwt0) / (nz * np.pi)) * w
    # normalize gain at Nyquist: sum of taps * (-1)^n
    nyq = (taps * np.cos(np.pi * n)).sum()
    taps = taps * (gain / nyq)
    return taps.astype(np.float32)


def band_pass(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
              transition_width, win_type: Window = Window.HAMMING,
              beta: float = 6.76):
    """Windowed-sinc band-pass, unity gain at band center
    (gr_firdes::band_pass)."""
    _sanity(sampling_freq, low_cutoff_freq, transition_width)
    if high_cutoff_freq <= low_cutoff_freq:
        raise ValueError("high_cutoff_freq must exceed low_cutoff_freq")
    ntaps = compute_ntaps(sampling_freq, transition_width, win_type, beta)
    return band_pass_2(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                       ntaps, win_type, beta)


def band_pass_2(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                ntaps, win_type: Window = Window.HAMMING, beta: float = 6.76):
    w = window(win_type, ntaps, beta)
    m = (ntaps - 1) // 2
    fwt0 = 2 * np.pi * low_cutoff_freq / sampling_freq
    fwt1 = 2 * np.pi * high_cutoff_freq / sampling_freq
    n = np.arange(ntaps) - m
    nz = np.where(n == 0, 1, n)
    taps = np.where(n == 0, (fwt1 - fwt0) / np.pi,
                    (np.sin(n * fwt1) - np.sin(n * fwt0)) / (nz * np.pi)) * w
    fc = 0.5 * (fwt0 + fwt1)
    center = (taps * np.cos(n * fc)).sum()
    taps = taps * (gain / center)
    return taps.astype(np.float32)


def complex_band_pass(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                      transition_width, win_type: Window = Window.HAMMING,
                      beta: float = 6.76):
    """Complex band-pass: rotated low-pass (gr_firdes::complex_band_pass)."""
    ntaps = compute_ntaps(sampling_freq, transition_width, win_type, beta)
    lp = low_pass_2(gain, sampling_freq,
                    (high_cutoff_freq - low_cutoff_freq) / 2, ntaps,
                    win_type, beta)
    fc = 0.5 * (low_cutoff_freq + high_cutoff_freq)
    n = np.arange(ntaps) - (ntaps - 1) // 2
    return (lp * np.exp(2j * np.pi * fc / sampling_freq * n)).astype(np.complex64)


def band_reject(gain, sampling_freq, low_cutoff_freq, high_cutoff_freq,
                transition_width, win_type: Window = Window.HAMMING,
                beta: float = 6.76):
    """Windowed-sinc band-reject (gr_firdes::band_reject)."""
    ntaps = compute_ntaps(sampling_freq, transition_width, win_type, beta)
    w = window(win_type, ntaps, beta)
    m = (ntaps - 1) // 2
    fwt0 = 2 * np.pi * low_cutoff_freq / sampling_freq
    fwt1 = 2 * np.pi * high_cutoff_freq / sampling_freq
    n = np.arange(ntaps) - m
    nz = np.where(n == 0, 1, n)
    taps = np.where(n == 0, 1.0 - (fwt1 - fwt0) / np.pi,
                    (np.sin(n * fwt0) - np.sin(n * fwt1)) / (nz * np.pi)) * w
    taps = taps * (gain / taps.sum())  # unity at DC
    return taps.astype(np.float32)


def root_raised_cosine(gain: float, sampling_freq: float, symbol_rate: float,
                       alpha: float, ntaps: int) -> np.ndarray:
    """Root-raised-cosine pulse (gr_firdes::root_raised_cosine).

    Standard closed form; singularities at t=0 and |t| = Ts/(4 alpha)
    resolved by their analytic limits.  Normalized so the peak tap follows
    the reference's spb scaling (unit energy scaled by gain)."""
    ntaps |= 1  # odd
    spb = sampling_freq / symbol_rate
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / spb  # in symbol durations
    a = alpha
    taps = np.zeros(ntaps)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-10:
            taps[i] = 1.0 - a + 4 * a / np.pi
        elif a > 0 and abs(abs(4 * a * ti) - 1.0) < 1e-8:
            taps[i] = (a / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * a))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * a))
            )
        else:
            num = (np.sin(np.pi * ti * (1 - a))
                   + 4 * a * ti * np.cos(np.pi * ti * (1 + a)))
            den = np.pi * ti * (1 - (4 * a * ti) ** 2)
            taps[i] = num / den
    taps = taps * gain / np.sqrt((taps ** 2).sum())
    return taps.astype(np.float32)


def gaussian(gain: float, spb: float, bt: float, ntaps: int) -> np.ndarray:
    """Gaussian pulse shape for GMSK (gr_firdes::gaussian).

    spb = samples per symbol, bt = bandwidth-time product."""
    ntaps |= 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / spb
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    taps = np.exp(-(t ** 2) / (2 * sigma ** 2))
    taps = taps * gain / taps.sum()
    return taps.astype(np.float32)


def hilbert(ntaps: int, win_type: Window = Window.RECTANGULAR,
            beta: float = 6.76) -> np.ndarray:
    """Hilbert transformer taps (gr_firdes::hilbert), odd length."""
    if ntaps % 2 == 0:
        raise ValueError("ntaps must be odd")
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    w = window(win_type, ntaps, beta)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(n % 2 != 0, 2.0 / (np.pi * n), 0.0)
    h[m] = 0.0
    h = h * w
    # normalize peak response at fs/4
    gain = abs(np.sum(h * np.sin(np.pi / 2 * n)))
    return (h / gain).astype(np.float32)


def inverse_sinc(gain, sampling_freq, cutoff, ntaps: int = 25):
    """sin(x)/x compensation filter (CIC droop correction helper)."""
    n = np.arange(ntaps) - (ntaps - 1) / 2
    f = cutoff / sampling_freq
    x = 2 * np.pi * f * n
    sinc = np.where(n == 0, 1.0, np.sin(x) / x)
    taps = 1.0 / sinc
    taps = taps * window(Window.BLACKMAN, ntaps)
    return (gain * taps / taps.sum()).astype(np.float32)
