"""Digital block wrappers for the graph runtime (port of the matching blocks
of ``grtpu.digital.blocks``).

Static-rate wrappers over grtpu_torch.digital.loops: CostasLoop,
FllBandEdge, BinarySlicer, FourLevelSlicer, DiffEncoder/DiffDecoder/
DiffPhasor, ConstellationDecoder, ConstellationReceiver, BytesToSyms,
MpskReceiver — plus first-class variable-rate clock recovery
(ClockRecoveryMM{FF,CC}), which the StreamExecutor runs through its FIFO
emission machinery (the analog of digital_clock_recovery_mm_cc.cc's
variable consume, lib/digital_clock_recovery_mm_cc.cc:160-217).
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.digital import loops
from grtpu_torch.digital.constellation import Constellation
from grtpu_torch.ops.mmse_interp import NTAPS


class CostasLoop(Block):
    """digital_costas_loop_cc."""

    def __init__(self, loop_bw: float, order: int, gains=None, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.loop_bw, self.order = loop_bw, order
        self.gains = gains

    def init_state(self):
        # host-made, like every block's state: the executor moves it
        return loops.costas_init_state("cpu")

    def apply(self, state, x):
        y, st = loops.costas_loop(x, state, self.loop_bw, self.order,
                                  self.gains)
        return st, y


class FllBandEdge(Block):
    """digital_fll_band_edge_cc."""

    def __init__(self, samps_per_sym: float, rolloff: float,
                 filter_size: int, loop_bw: float, gains=None, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.history = filter_size
        super().__init__(name)
        self.sps, self.rolloff = samps_per_sym, rolloff
        self.filter_size, self.loop_bw = filter_size, loop_bw
        self.gains = gains

    def init_state(self):
        return loops.fll_init_state("cpu")

    def apply(self, state, x):
        y, st = loops.fll_band_edge(x, state, self.sps, self.rolloff,
                                    self.filter_size, self.loop_bw,
                                    self.gains)
        return st, y


class BinarySlicer(Block):
    """digital_binary_slicer_fb."""

    def __init__(self, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)

    def apply(self, state, x):
        return state, loops.binary_slicer(x)


class FourLevelSlicer(Block):
    """4FSK dibit slicer: frequency level -> dibit (DMR convention)."""

    def __init__(self, scale: float = 1.0, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.scale = scale

    def apply(self, state, x):
        v = x * self.scale  # nominal levels -3,-1,+1,+3
        sym = torch.where(v > 2, 0b01,
                          torch.where(v > 0, 0b00,
                                      torch.where(v > -2, 0b10, 0b11)))
        return state, sym.to(torch.uint8)


class DiffEncoder(Block):
    """gr_diff_encoder_bb."""

    def __init__(self, modulus: int, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.modulus = modulus

    def init_state(self):
        return torch.zeros((), dtype=torch.uint8)

    def apply(self, state, x):
        y, st = loops.diff_encode(x, state, self.modulus)
        return st, y


class DiffDecoder(Block):
    """gr_diff_decoder_bb."""

    def __init__(self, modulus: int, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.modulus = modulus

    def init_state(self):
        return torch.zeros((), dtype=torch.uint8)

    def apply(self, state, x):
        y, st = loops.diff_decode(x, state, self.modulus)
        return st, y


class DiffPhasor(Block):
    """gr_diff_phasor_cc."""

    def __init__(self, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)

    def init_state(self):
        return torch.ones((), dtype=torch.complex64)

    def apply(self, state, x):
        y, st = loops.diff_phasor(x, state)
        return st, y


class ConstellationDecoder(Block):
    """digital_constellation_decoder_cb: hard decisions, no loop."""

    def __init__(self, constellation: Constellation, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.constellation = constellation

    def apply(self, state, x):
        return state, self.constellation.decision_maker(x).to(torch.uint8)


class ConstellationReceiver(Block):
    """digital_constellation_receiver_cb: loop + decisions (symbol out)."""

    def __init__(self, constellation: Constellation, loop_bw: float,
                 name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.constellation = constellation
        self.loop_bw = loop_bw

    def init_state(self):
        return loops.costas_init_state("cpu")

    def apply(self, state, x):
        syms, _, st = loops.constellation_receiver(
            x, state, self.constellation, self.loop_bw)
        return st, syms.to(torch.uint8)


class BytesToSyms(Block):
    """gr_bytes_to_syms: byte -> 8 NRZ float symbols (+1/-1), MSB first."""

    def __init__(self, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.float32),)
        self.interp = 8
        super().__init__(name)

    def apply(self, state, x):
        shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=x.device)
        bits = (x[:, None].to(torch.int32) >> shifts[None, :]) & 1
        return state, (bits.reshape(-1) * 2 - 1).to(torch.float32)


class _ClockRecoveryMMBase(Block):
    """Shared machinery for the M&M timing recovery graph blocks.

    Variable-rate: apply returns (y_padded, n_valid) with the valid symbols
    a contiguous prefix; the executor FIFOs them to the downstream segment.
    Chunk-boundary exactness: the frozen pointer trails the boundary by at
    most NTAPS + omega + 2 samples, covered by ``history``, and the
    freeze-at-invalid loop recomputes the deferred symbol identically next
    chunk.  Analog: digital_clock_recovery_mm_{cc,ff}.cc general_work
    (variable consume at :160-217)."""

    variable_rate = True
    _complex = False

    def __init__(self, omega: float, gain_omega: float, mu: float,
                 gain_mu: float, omega_relative_limit: float = 0.001,
                 name=None):
        dt = torch.complex64 if self._complex else torch.float32
        self.in_ports = (Port(dt),)
        self.out_ports = (Port(dt),)
        self.history = NTAPS + int(np.ceil(omega)) + 3
        super().__init__(name)
        self.omega = float(omega)
        self.gain_omega, self.mu0, self.gain_mu = (float(gain_omega),
                                                   float(mu), float(gain_mu))
        self.omega_relative_limit = float(omega_relative_limit)

    @property
    def nominal_rate(self):
        return 1.0 / self.omega

    def max_out_for(self, n_delivered: int) -> int:
        return int(np.ceil(n_delivered / max(
            self.omega * (1 - self.omega_relative_limit), 1.0)))

    def init_state(self):
        return loops.mm_init_state(self.omega, self.mu0,
                                   complex_mode=self._complex, device="cpu")

    def apply(self, state, x):
        fn = (loops.clock_recovery_mm_cc if self._complex
              else loops.clock_recovery_mm_ff)
        ys, n_valid, st = fn(x, state, self.omega, self.gain_omega,
                             self.gain_mu, self.omega_relative_limit)
        st = loops.rebase_mm_state(st, x.shape[0] - (self.history - 1))
        return st, (ys, n_valid)


class ClockRecoveryMMFF(_ClockRecoveryMMBase):
    """digital_clock_recovery_mm_ff as a variable-rate graph block."""


class ClockRecoveryMMCC(_ClockRecoveryMMBase):
    """digital_clock_recovery_mm_cc as a variable-rate graph block."""

    _complex = True


class MpskReceiver(Block):
    """digital_mpsk_receiver_cc (legacy combined carrier+timing receiver):
    Costas derotation followed by M&M timing, one symbol-rate sample per
    sps inputs (a fixed-rate approximation of the reference's variable
    consumption, as in grtpu)."""

    def __init__(self, m: int, sps: float, costas_bw: float = 0.062,
                 gain_mu: float = 0.175, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.decim = int(round(sps))
        super().__init__(name)
        self.m, self.sps = m, sps
        self.costas_bw = costas_bw
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu

    def init_state(self):
        return (loops.costas_init_state("cpu"),
                loops.mm_init_state(float(self.sps), 0.5, complex_mode=True,
                                    device="cpu"))

    def apply(self, state, x):
        cst, mm = state
        derot, cst2 = loops.costas_loop(x, cst, self.costas_bw,
                                        self.m if self.m in (2, 4, 8) else 4)
        n_out = x.shape[0] // self.decim
        ys, _, mm2 = loops.clock_recovery_mm_cc(
            derot, mm, float(self.sps), self.gain_omega, self.gain_mu, 0.005)
        mm2 = loops.rebase_mm_state(mm2, x.shape[0])
        return (cst2, mm2), ys[:n_out]
