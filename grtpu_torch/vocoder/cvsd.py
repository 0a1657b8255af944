"""CVSD (continuously variable slope delta) codec as a per-bit recurrence.

Port of ``grtpu.vocoder.cvsd``.  Reference behavior:
gr-vocoder/lib/vocoder_cvsd_{encode_sb,decode_bs}.cc — Bluetooth-flavoured
CVSD: 1 bit per input sample, bits packed MSB-first into bytes (encode is a
sync_decimator by 8, decode a sync_interpolator by 8).  Per-bit feedback:
sign comparison against an integer accumulator, step-size adaptation on runs
of J equal bits within a K-bit shift register, accumulator decay and
clamping.  Defaults are the Bluetooth parameters.

The reference encoder and decoder state machines are NOT mirror images, and
both quirks are reproduced for parity, as in grtpu:
  * the encoder adapts the step from the runner BEFORE shifting in the
    current bit; the decoder shifts first and adapts including it;
  * the decoder ORs the raw mask value (``byte & 2^(7-k)``, not 0/1) into
    its shift register.

A stream is a sequential loop over bits; the steps run over every channel at
once (state leaves carry the channels on their leading axes) through
:func:`grtpu_torch.runtime.step_graph.step_scan`.  The runner, a uint32 in
grtpu, is held in int64 masked to 32 bits (torch's uint32 lacks most
kernels).  The step/accum decays are exact in float32 for the default
(power-of-two fraction) parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port, port_b, port_s
from grtpu_torch.runtime.step_graph import step_scan
from grtpu_torch.utils.device import resolve

_U32 = 0xFFFFFFFF


def _round_half_up(x):
    """C's cvsd_round: floor(x + 0.5)."""
    return torch.floor(x + 0.5).to(torch.int32)


class _CvsdParams:
    def __init__(self, min_step=10, max_step=1280, step_decay=0.9990234375,
                 accum_decay=0.96875, K=32, J=4,
                 pos_accum_max=32767, neg_accum_max=-32767):
        if K > 32 or J > K:
            raise ValueError("CVSD requires J <= K <= 32")
        self.min_step, self.max_step = min_step, max_step
        self.step_decay, self.accum_decay = step_decay, accum_decay
        self.K, self.J = K, J
        self.pos_accum_max, self.neg_accum_max = pos_accum_max, neg_accum_max
        self.j_mask = np.uint32((1 << J) - 1)


def cvsd_init_state(p: _CvsdParams, channels: int = None, device=None):
    """(accum, stepsize, runner, loop_counter): int32, int32, int64 (the
    uint32 runner), int32; scalars, or a leading axis of ``channels``."""
    dev = resolve(device)
    lead = () if channels is None else (int(channels),)

    def full(v, dtype=torch.int32):
        return torch.full(lead, v, dtype=dtype, device=dev)

    return (full(0), full(p.min_step), full(0, torch.int64), full(1))


def _update_accum(p, accum, bit_nonzero, stepsize):
    accum = accum + torch.where(bit_nonzero, stepsize, -stepsize)
    accum = _round_half_up(accum.to(torch.float32) * p.accum_decay)
    return accum.clamp(p.neg_accum_max, p.pos_accum_max)


def _adapt_step(p, stepsize, runner, loop_counter):
    """Grow on a run of J equal bits in the low J of runner, else decay."""
    jm = int(p.j_mask)
    masked = runner & jm
    run = (masked == jm) | (masked == 0)
    grown = torch.clamp(stepsize + p.min_step, max=p.max_step)
    decayed = torch.clamp(
        _round_half_up(stepsize.to(torch.float32) * p.step_decay),
        min=p.min_step)
    return torch.where(loop_counter >= p.J,
                       torch.where(run, grown, decayed), stepsize)


def _scan(step, state, xs, out_dtype):
    lead = tuple(state[0].shape)
    nb = int(np.prod(lead)) if lead else 1
    flat = tuple(s.reshape(nb) for s in state)
    seq = xs.reshape(nb, xs.shape[-1]).t().contiguous()
    out = torch.empty(seq.shape, dtype=out_dtype, device=xs.device)
    fin = step_scan(step, flat, seq, out)
    return tuple(s.reshape(lead) for s in fin), out.t().reshape(xs.shape)


def cvsd_encode_bits(p: _CvsdParams, state, pcm):
    """int16 samples (..., T) -> one bit per sample (uint8 0/1)."""

    def step(carry, x):
        accum, stepsize, runner, loop_counter = carry
        bit = (x.to(torch.int32) >= accum).to(torch.int32)
        accum = _update_accum(p, accum, bit != 0, stepsize)
        # Encoder order: adapt from the runner EXCLUDING the current bit.
        stepsize = _adapt_step(p, stepsize, runner, loop_counter)
        runner = ((runner << 1) | bit) & _U32
        loop_counter = torch.where(loop_counter <= p.K,
                                   loop_counter + 1, loop_counter)
        return (accum, stepsize, runner, loop_counter), bit.to(torch.uint8)

    return _scan(step, state, pcm, torch.uint8)


def cvsd_decode_bits(p: _CvsdParams, state, bit_values):
    """Mask-valued bits (byte & 2^(7-k), as the reference decoder sees them)
    -> int16 samples (the post-update accumulator)."""

    def step(carry, bv):
        accum, stepsize, runner, loop_counter = carry
        # Decoder order: shift the (mask-valued) bit in FIRST, then adapt.
        runner = ((runner << 1) | bv.to(torch.int64)) & _U32
        stepsize = _adapt_step(p, stepsize, runner, loop_counter)
        accum = _update_accum(p, accum, bv != 0, stepsize)
        loop_counter = torch.where(loop_counter <= p.K,
                                   loop_counter + 1, loop_counter)
        return ((accum, stepsize, runner, loop_counter),
                accum.to(torch.int16))

    return _scan(step, state, bit_values, torch.int16)


class CvsdEncode(Block):
    """vocoder_cvsd_encode_sb: int16 -> packed bits, 8 samples per byte."""

    in_ports = (port_s(),)
    out_ports = (port_b(),)
    decim = 8

    def __init__(self, name=None, **params):
        self.params = _CvsdParams(**params)
        super().__init__(name)

    def init_state(self):
        return cvsd_init_state(self.params, device="cpu")

    def apply(self, state, x):
        state, bits = cvsd_encode_bits(self.params, state, x)
        packed = (bits.reshape(-1, 8).to(torch.int32)
                  << torch.arange(7, -1, -1, device=x.device,
                                  dtype=torch.int32)).sum(-1)
        return state, packed.to(torch.uint8)


class CvsdDecode(Block):
    """vocoder_cvsd_decode_bs: packed bits -> int16, 8 samples per byte."""

    in_ports = (port_b(),)
    out_ports = (port_s(),)
    interp = 8

    def __init__(self, name=None, **params):
        self.params = _CvsdParams(**params)
        super().__init__(name)

    def init_state(self):
        return cvsd_init_state(self.params, device="cpu")

    def apply(self, state, x):
        # The reference pulls bits as byte & 2^(7-k) and feeds that raw mask
        # value into the state machine — reproduce exactly.
        masks = 1 << torch.arange(7, -1, -1, device=x.device,
                                  dtype=torch.int32)
        bit_values = (x[:, None].to(torch.int32) & masks).reshape(-1)
        return cvsd_decode_bits(self.params, state, bit_values)


# ------------------------------------------------------------- blks2 wrappers
def _cvsd_hier():
    from grtpu_torch.runtime.graph import HierBlock

    class CvsdEncodeFB(HierBlock):
        """blks2.cvsd_encode (gr-vocoder/python/cvsd.py cvsd_encode_fb):
        float (+-1) -> x32000 -> interpolate -> float_to_short -> CVSD
        bits."""

        def __init__(self, resample: int = 8, bw: float = 0.5, name=None):
            super().__init__(name)
            from grtpu_torch.blocks.gengen import MultiplyConst
            from grtpu_torch.blocks.convert import FloatToShort
            from grtpu_torch.blocks.filter import InterpFirFilter
            from grtpu_torch.utils import firdes

            g = self.graph
            pin = g.add_input(Port(torch.float32))
            pout = g.add_output(Port(torch.uint8))
            taps = firdes.low_pass(resample, resample, bw, 2 * bw)
            g.connect(pin, MultiplyConst(32000.0, dtype=torch.float32),
                      InterpFirFilter(resample, taps, "fff"),
                      FloatToShort(), CvsdEncode(), pout)

    class CvsdDecodeBF(HierBlock):
        """blks2.cvsd_decode (cvsd_decode_bf): CVSD bits -> shorts ->
        float -> decimating low-pass -> /32000."""

        def __init__(self, resample: int = 8, bw: float = 0.5, name=None):
            super().__init__(name)
            from grtpu_torch.blocks.gengen import MultiplyConst
            from grtpu_torch.blocks.convert import ShortToFloat
            from grtpu_torch.blocks.filter import FirFilter
            from grtpu_torch.utils import firdes

            g = self.graph
            pin = g.add_input(Port(torch.uint8))
            pout = g.add_output(Port(torch.float32))
            taps = firdes.low_pass(1, 1, bw, 2 * bw)
            g.connect(pin, CvsdDecode(), ShortToFloat(),
                      FirFilter(resample, taps, "fff"),
                      MultiplyConst(1.0 / 32000.0, dtype=torch.float32), pout)

    return CvsdEncodeFB, CvsdDecodeBF


CvsdEncodeFB, CvsdDecodeBF = _cvsd_hier()
