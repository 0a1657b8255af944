"""CPM phase-pulse design + modulator, in PyTorch.

Port of ``grtpu.digital.cpm``.  Analogs: gr_cpm (gnuradio-core/src/lib/
general gr_cpm phase taps: LREC, LRC, LSRC, TFM, GAUSSIAN shapes),
digital_cpmmod_bc / digital_gmskmod_bc (hier CPM modulator: symbols ->
interpolated phase pulse -> FM), and gr-digital/python/cpm.py's modem
wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.ops import dsp
from grtpu_torch.ops.fir import interp_fir_filter
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import resolve


def phase_response(cpm_type: str, samples_per_sym: int, L: int,
                   beta: float = 0.3) -> np.ndarray:
    """gr_cpm::phase_response: frequency-pulse taps of length L*sps,
    normalized to sum 0.5 (phase advance of pi*h per symbol with h folded
    in by the modulator).  Host numpy (a copy of grtpu's).

    cpm_type: 'LREC' (rectangular), 'LRC' (raised cosine), 'LSRC'
    (spectral raised cosine), 'TFM' (tamed FM), 'GAUSSIAN'.
    """
    sps = samples_per_sym
    n = L * sps
    t = (np.arange(n) + 0.5) / sps  # in symbol durations, 0..L
    if cpm_type.upper() == "LREC":
        g = np.ones(n)
    elif cpm_type.upper() == "LRC":
        g = 1.0 - np.cos(2 * np.pi * t / L)
    elif cpm_type.upper() == "LSRC":
        # spectral raised cosine: sinc * cos / (1 - (2 beta t/L)^2)
        tt = 2 * t / L - 1.0
        num = np.sinc(tt) * np.cos(np.pi * beta * tt)
        den = 1.0 - (2 * beta * tt) ** 2
        g = np.where(np.abs(den) < 1e-8, np.pi / 4 * np.sinc(tt), num / den)
    elif cpm_type.upper() == "TFM":
        # tamed FM: g = (g0(t-T) + 2 g0(t) + g0(t+T))/4 with g0 ~ sinc-ish
        def g0(tau):
            x = np.pi * tau
            return np.where(np.abs(tau) < 1e-6, 1.0,
                            np.sin(x) / np.where(x == 0, 1, x))
        g = (g0(t - L / 2 - 1) + 2 * g0(t - L / 2) + g0(t - L / 2 + 1)) / 4.0
    elif cpm_type.upper() in ("GAUSSIAN", "GMSK"):
        g = firdes.gaussian(1.0, sps, beta, n).astype(np.float64)
    else:
        raise ValueError(f"unknown cpm type {cpm_type}")
    g = g / g.sum() * 0.5
    return g.astype(np.float32)


class CpmModulator:
    """digital_cpmmod_bc semantics: M-ary symbols -> CPM baseband on
    ``device`` (the card unless the caller names another).

    symbols in {0..M-1} map to odd levels {-(M-1)..(M-1)}; the phase pulse
    (length L symbols) shapes the instantaneous frequency; h = modulation
    index."""

    def __init__(self, cpm_type: str = "LREC", h: float = 0.5,
                 samples_per_sym: int = 2, L: int = 1, M: int = 2,
                 beta: float = 0.3, device=None):
        self.sps = samples_per_sym
        self.M = M
        self.h = h
        self.taps = phase_response(cpm_type, samples_per_sym, L, beta)
        self.device = resolve(device)

    def modulate(self, symbols: np.ndarray) -> torch.Tensor:
        lv = torch.from_numpy(
            2 * np.asarray(symbols, np.float32) - (self.M - 1)).to(self.device)
        kp = -(-len(self.taps) // self.sps)
        xh = torch.cat([lv.new_zeros(kp - 1), lv])
        # each unit-level symbol advances the phase by pi * h * level
        freq = interp_fir_filter(xh, self.taps, self.sps)
        y, _ = dsp.frequency_modulator(freq, 0.0, 2 * np.pi * self.h)
        return y
