"""Channel model: impairment injection for loopback testing, in PyTorch.

Port of ``grtpu.models.channel``.  Analog of blks2impl/channel_model.py
(+ hier/gr_channel_model.cc): AWGN + carrier frequency/phase offset +
multipath FIR + timing (epsilon) offset — the reference's only
fault-injection facility.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.blocks.filter import FirFilter, FractionalInterpolator
from grtpu_torch.ops import dsp, noise
from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.runtime.graph import HierBlock


class _Rotator(Block):
    def __init__(self, phase_inc: float, phase0: float = 0.0, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.inc = phase_inc
        self.phase0 = phase0

    def init_state(self):
        return torch.tensor(self.phase0, dtype=torch.float32)

    def apply(self, state, x):
        y, ph = dsp.rotate(x, state, self.inc)
        return ph, y


class ChannelModel(HierBlock):
    """AWGN + CFO + multipath channel.

    Args mirror channel_model.py: noise_voltage (std per complex dim),
    frequency_offset (cycles/sample), epsilon (timing skew, a fractional
    resampler when != 1), taps (multipath FIR, default [1]), noise_seed.
    """

    def __init__(self, noise_voltage: float = 0.0,
                 frequency_offset: float = 0.0, epsilon: float = 1.0,
                 taps=(1.0 + 0.0j,), noise_seed: int = 3021, name=None):
        super().__init__(name)
        taps = np.asarray(taps, np.complex64)
        i = self.graph.add_input(Port(torch.complex64))
        o = self.graph.add_output(Port(torch.complex64))
        chain = [FirFilter(1, taps, "ccc")]
        if epsilon != 1.0:
            chain.append(FractionalInterpolator(0.0, epsilon, torch.complex64))
        chain.append(_Rotator(2 * np.pi * frequency_offset))
        if noise_voltage > 0.0:
            # in-block AWGN keeps the graph single-rate even when epsilon
            # resamples the signal path
            chain.append(_AwgnAdder(noise_voltage, noise_seed))
        self.graph.connect(i, *chain, o)


class _AwgnAdder(Block):
    """Add complex AWGN with per-dimension std ``voltage`` (the reference's
    noise_voltage convention).  The noise is the counter-based stream of
    ``ops.noise`` keyed by ``seed``; the carried state is the count of
    samples drawn, so a resumed run continues the stream bit for bit."""

    def __init__(self, voltage: float, seed: int = 3021, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.voltage = voltage
        self.seed = seed

    def init_state(self):
        return torch.zeros((), dtype=torch.int64)

    def apply(self, state, x):
        re, im = noise.normal_pair(self.seed, state, x.shape[0])
        y = x + torch.complex(re * self.voltage, im * self.voltage)
        return state + x.shape[0], y.to(torch.complex64)
