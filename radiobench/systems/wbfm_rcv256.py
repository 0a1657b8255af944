"""The WBFM receiver on the port: a complex64 capture at the quadrature
rate -> QuadratureDemod -> FirFilter (decimation 8, the source's 617-tap
audio low-pass on the hand kernel) -> FmDeemph, as one Graph."""

from __future__ import annotations

import math

from radiobench import signals


def sources(cfg, mix, seed, device):
    """(sources, 1, source_samples) complex64 captures."""
    return signals.wideband_capture(cfg, mix["source_samples"], mix["sources"],
                                    seed, device)[:, None]


def graph(cfg):
    import torch

    from grtpu_torch import Graph, Port
    from grtpu_torch.blocks.analog import QuadratureDemod
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.models.fm import FmDeemph
    from grtpu_torch.utils import firdes

    audio_rate = cfg["quad_rate"] / cfg["audio_decimation"]
    af = cfg["audio_filter"]
    taps = firdes.low_pass(1.0, cfg["quad_rate"], af["cutoff_hz"],
                           af["transition_hz"], firdes.Window.HAMMING)
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.float32))
    g.connect(pin,
              QuadratureDemod(cfg["quad_rate"]
                              / (2 * math.pi * cfg["max_deviation_hz"])),
              FirFilter(cfg["audio_decimation"], taps, "fff",
                        impl=cfg["audio_fir_impl"]),
              FmDeemph(audio_rate, cfg["deemphasis_tau"]),
              pout)
    return g
