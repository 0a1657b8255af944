"""Adaptive equalizers: CMA, LMS decision-directed, kurtotic, in PyTorch.

Port of ``grtpu.digital.equalizers``.  Analogs (gr-digital):
digital_cma_equalizer_cc, digital_lms_dd_equalizer_cc,
digital_kurtotic_equalizer_cc — all built on gr_adaptive_fir_ccc (a tap
update per output).

The tap-update recurrence is a loop over samples carrying the tap vector:
one K-tap dot and a rank-1 update a step, on the samples' device with no
host read.  Sample-rate operation (sps=1 after matched filtering /
decimation), like the reference blocks' typical use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grtpu_torch.digital.constellation import Constellation
from grtpu_torch.digital.loops import _on, _point
from grtpu_torch.runtime.block import Block, Port


def _windows(x: torch.Tensor, ntaps: int) -> torch.Tensor:
    """w[t] = x[t : t + ntaps] reversed (newest sample first), (n, ntaps)."""
    return torch.flip(x.unfold(0, ntaps, 1), dims=(1,))


def _stack(ys, x):
    return (torch.stack(ys) if ys else x.new_zeros((0,))).to(torch.complex64)


def cma_equalize(x: torch.Tensor, taps: torch.Tensor, modulus: float,
                 mu: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constant-modulus algorithm (digital_cma_equalizer_cc):
    error = y (|y|^2 - modulus); taps -= mu * err * conj(window).

    x carries ntaps-1 history samples.  Returns (y, taps')."""
    ys = []
    for w in _windows(x, taps.shape[0]).unbind(0):
        y = (taps * w).sum()
        err = y * (torch.abs(y) ** 2 - modulus)
        taps = taps - mu * err * torch.conj(w)
        ys.append(y)
    return _stack(ys, x), taps


def lms_dd_equalize(x: torch.Tensor, taps: torch.Tensor,
                    points: torch.Tensor, mu: float):
    """Decision-directed LMS (digital_lms_dd_equalizer_cc):
    error = decision(y) - y; taps += mu * err * conj(window)."""
    ys = []
    for w in _windows(x, taps.shape[0]).unbind(0):
        y = (taps * w).sum()
        d = _point(points, torch.argmin(torch.abs(y - points) ** 2))
        taps = taps + mu * (d - y) * torch.conj(w)
        ys.append(y)
    return _stack(ys, x), taps


def kurtotic_equalize(x: torch.Tensor, taps: torch.Tensor, mu: float,
                      stats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """Sign-kurtosis-maximizing blind equalizer
    (digital_kurtotic_equalizer_cc, after Guo/Zhao/Sun 2004).

    Running moments p = E|y|^2, q = E y^2, m4 = E|y|^4 (EWMA, alpha=0.01)
    form the kurtosis u = m4 - 2p^2 - q^2; the tap-update direction is the
    reference's error term — sign(u) (componentwise 0/1 indicator on
    re/im), scaled by 1/p^3, minus |u| conj(y), each component clipped to
    +-1 (digital_kurtotic_equalizer_cc.h:67-102).  taps += mu * window *
    error.  Returns (y, taps', (p, q, m4))."""
    alpha, eps = 0.01, 1e-12
    p, q, m4 = stats
    ys = []
    for w in _windows(x, taps.shape[0]).unbind(0):
        y = (taps * w).sum()
        nrm = torch.abs(y) ** 2
        cnj = torch.conj(y)
        p = (1 - alpha) * p + alpha * nrm + eps
        q = (1 - alpha) * q + alpha * y * y + (eps + 1j * eps)
        m4 = (1 - alpha) * m4 + alpha * nrm * nrm + eps
        u = m4 - 2.0 * p * p - q * q
        sgn = torch.complex((u.real >= 0).to(torch.float32),
                            (u.imag >= 0).to(torch.float32))
        F = (1.0 / (p * p * p)) * (
            sgn * (nrm * cnj - 2.0 * p * cnj - torch.conj(q) * y)
            - torch.abs(u) * cnj)
        err = torch.complex(torch.clamp(F.real, -1.0, 1.0),
                            torch.clamp(F.imag, -1.0, 1.0))
        taps = taps + mu * w * err
        ys.append(y)
    return _stack(ys, x), taps, (p, q, m4)


def center_spike_taps(ntaps: int) -> np.ndarray:
    t = np.zeros(ntaps, np.complex64)
    t[ntaps // 2] = 1.0
    return t


class CmaEqualizer(Block):
    """digital_cma_equalizer_cc block wrapper (sps=1)."""

    def __init__(self, num_taps: int = 11, modulus: float = 1.0,
                 mu: float = 0.01, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.history = num_taps
        super().__init__(name)
        self.num_taps, self.modulus, self.mu = num_taps, modulus, mu

    def init_state(self):
        return torch.from_numpy(center_spike_taps(self.num_taps))

    def apply(self, state, x):
        y, taps = cma_equalize(x, state, self.modulus, self.mu)
        return taps, y


class KurtoticEqualizer(Block):
    """digital_kurtotic_equalizer_cc block wrapper (sps=1): the state
    carries the tap vector and the running moments (p = E|y|^2,
    q = E y^2, m4 = E|y|^4) that drive the kurtosis-sign error term."""

    def __init__(self, num_taps: int = 15, mu: float = 0.01, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.history = num_taps
        super().__init__(name)
        self.num_taps, self.mu = num_taps, mu

    def init_state(self):
        # reference inits taps[0] = 1 (digital_kurtotic_equalizer_cc.cc:39)
        t0 = torch.zeros(self.num_taps, dtype=torch.complex64)
        t0[0] = 1.0
        return (t0, (torch.zeros((), dtype=torch.float32),
                     torch.zeros((), dtype=torch.complex64),
                     torch.zeros((), dtype=torch.float32)))

    def apply(self, state, x):
        taps, stats = state
        y, taps2, stats2 = kurtotic_equalize(x, taps, self.mu, stats)
        return (taps2, stats2), y


class LmsDdEqualizer(Block):
    """digital_lms_dd_equalizer_cc block wrapper."""

    def __init__(self, constellation: Constellation, num_taps: int = 11,
                 mu: float = 0.01, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.history = num_taps
        super().__init__(name)
        self.points = np.asarray(constellation.points, np.complex64)
        self.num_taps, self.mu = num_taps, mu

    def init_state(self):
        return torch.from_numpy(center_spike_taps(self.num_taps))

    def apply(self, state, x):
        y, taps = lms_dd_equalize(x, state, _on(self.points, x.device),
                                  self.mu)
        return taps, y
