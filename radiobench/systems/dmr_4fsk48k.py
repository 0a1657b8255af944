"""Config #4 on the port: the 4FSK receiver as a variable-rate Graph
(QuadratureDemod -> the matched root-raised-cosine FirFilter ->
ClockRecoveryMMFF -> FourLevelSlicer; the dibits and the soft symbols
out) for a continuous channel."""

from __future__ import annotations

import torch

from radiobench import signals


def sources(cfg, mix, seed, device):
    """(sources, 1, source_samples) complex64: each source its own dibits,
    carrier offset and noise."""
    rows, n = mix["sources"], mix["source_samples"]
    n_sym = -(-n // cfg["samples_per_symbol"])
    d = signals.dmr_dibits(rows, n_sym, seed, 100, device)
    iq = signals.fsk4_modulate(d, cfg)[:, :n]
    return signals.dmr_channel(iq, cfg, seed, 101)[:, None]


def graph(cfg):
    from grtpu_torch import Graph, Port
    from grtpu_torch.blocks.analog import QuadratureDemod
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.digital.blocks import ClockRecoveryMMFF, FourLevelSlicer
    from grtpu_torch.digital.modems import Fsk4Modem

    modem = Fsk4Modem(samples_per_symbol=cfg["samples_per_symbol"],
                      symbol_rate=cfg["symbol_rate"],
                      deviation=cfg["deviation_hz"], device="cpu")
    sps = cfg["samples_per_symbol"]
    mm = cfg["clock_recovery"]
    mm_block = ClockRecoveryMMFF(
        omega=sps, gain_omega=0.25 * mm["gain_mu"] ** 2, mu=mm["mu"],
        gain_mu=mm["gain_mu"], omega_relative_limit=mm["omega_relative_limit"])
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    dibits = g.add_output(Port(torch.uint8))
    levels = g.add_output(Port(torch.float32))
    g.connect(pin, QuadratureDemod(1.0 / modem.sensitivity),
              FirFilter(1, modem.rx_taps / sps, "fff", impl="mxu"), mm_block,
              FourLevelSlicer(scale=3.0), dibits)
    # the soft symbols too: the check compares them as well as the dibits
    g.connect(mm_block, levels)
    return g

