"""Analog blocks of the WBFM chain (port of ``grtpu.blocks.analog``).

Analogs: gr_quadrature_demod_cf, gr_frequency_modulator_fc.
"""

from __future__ import annotations

import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.ops import dsp


class QuadratureDemod(Block):
    """gr_quadrature_demod_cf (general/gr_quadrature_demod_cf.cc:47-62)."""

    def __init__(self, gain: float, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.float32),)
        self.history = 2
        super().__init__(name)
        self.gain = gain

    def apply(self, state, x):
        return state, dsp.quadrature_demod(x, self.gain)


class FrequencyModulator(Block):
    """gr_frequency_modulator_fc; carried state is the phase."""

    def __init__(self, sensitivity: float, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.sensitivity = sensitivity

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        y, ph = dsp.frequency_modulator(x, state, self.sensitivity)
        return ph, y
