"""The WBFM receive chain (port of ``WfmRcv`` and ``FmDeemph`` from
``grtpu.models.fm``), with the same taps and the same wiring.

North-star config #1 (BASELINE.json): quadrature_demod -> decimating audio
FIR -> deemphasis (blks2impl/wfm_rcv.py:69).
"""

from __future__ import annotations

import math

import torch

from grtpu_torch.runtime.block import Port
from grtpu_torch.runtime.graph import HierBlock
from grtpu_torch.blocks.analog import QuadratureDemod
from grtpu_torch.blocks.filter import FirFilter, IirFilter
from grtpu_torch.utils import firdes


class FmDeemph(HierBlock):
    """Single-pole IIR de-emphasis (blks2impl/fm_emph.py fm_deemph).

    Bilinear-transformed RC lowpass H(s) = 1/(1 + s*tau), prewarped:
        w_c = 1/tau;  w_ca = 2 fs tan(w_c / (2 fs));  k = w_ca/(2 fs)
        H(z) = b0 (1 + z^-1) / (1 - p1 z^-1),  p1 = (1-k)/(1+k),
        b0 = k/(1+k)  (unity DC gain).

    As in grtpu, this is the response the reference intends, not its
    fm_emph.py taps (whose feedback sign is inverted for gri_iir, a GNU
    Radio 3.5 defect corrected upstream in 3.8).
    """

    def __init__(self, fs: float, tau: float = 75e-6, name=None):
        super().__init__(name)
        k = math.tan(1.0 / (tau * 2.0 * fs))
        p1 = (1.0 - k) / (1.0 + k)
        b0 = k / (1.0 + k)
        btaps = [b0, b0]
        fbtaps = [1.0, p1]  # iir convention: y += fbtaps[1]*y[n-1]
        i = self.graph.add_input(Port(torch.float32))
        o = self.graph.add_output(Port(torch.float32))
        self.graph.connect(i, IirFilter(btaps, fbtaps), o)


class WfmRcv(HierBlock):
    """Broadcast WBFM receiver (blks2impl/wfm_rcv.py:69).

    quad_rate IQ in -> quadrature_demod -> decimating audio FIR -> deemph
    -> audio_rate float out.
    """

    def __init__(self, quad_rate: float, audio_decimation: int, name=None):
        super().__init__(name)
        max_dev = 75e3
        fm_demod_gain = quad_rate / (2 * math.pi * max_dev)
        audio_rate = quad_rate / audio_decimation

        audio_taps = firdes.low_pass(
            1.0, quad_rate, audio_rate / 2 - 1e3, audio_rate / 10,
            firdes.Window.HAMMING)

        i = self.graph.add_input(Port(torch.complex64))
        o = self.graph.add_output(Port(torch.float32))
        self.fm_demod = QuadratureDemod(fm_demod_gain)
        self.audio_filter = FirFilter(audio_decimation, audio_taps, "fff")
        self.deemph = FmDeemph(audio_rate, 75e-6)
        self.graph.connect(i, self.fm_demod, self.audio_filter, self.deemph, o)
