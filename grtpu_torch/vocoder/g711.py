"""G.711 A-law / mu-law companding as elementwise integer ops.

Port of ``grtpu.vocoder.g711``.  Reference behavior:
gr-vocoder/lib/vocoder_{alaw,ulaw}_{encode_sb,decode_bs}.cc calling the Sun
g711 conversions (gr-vocoder/lib/g7xx/g711.c:113-280).  Each conversion is a
fixed chain of compares and shifts over the whole time-block (no tables, no
branches); every function runs where its input lies.

Conventions (bit-exact over all 65536 inputs, as grtpu's):
  * A-law: 16-bit two's-complement in, segment ends {0xFF..0x7FFF}, negative
    values mapped as ``-x - 8``, result XORed with 0x55 (sign bit SET for
    non-negative).
  * mu-law: bias 0x84 added to magnitude, same segment ends, complemented
    code word out.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, port_b, port_s
from grtpu_torch.utils.device import constant

# Segment upper bounds shared by both laws (g711.c:38-39).
_SEG_END = np.array([0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF, 0x3FFF, 0x7FFF],
                    np.int32)
_BIAS = 0x84


class _Tables:
    seg_end = _SEG_END


_TABLES = _Tables()


def _seg_number(mag):
    """Index of the first segment end >= mag (8 = out of range)."""
    ends = constant(_TABLES, "seg_end", mag.device)
    return (mag[..., None] > ends).sum(-1, dtype=torch.int32)


def linear_to_alaw(pcm):
    """int16 linear PCM -> uint8 A-law (g711.c:113-142 semantics)."""
    x = pcm.to(torch.int32)
    neg = x < 0
    mask = torch.where(neg, 0x55, 0xD5)
    mag = torch.where(neg, -x - 8, x)
    seg = _seg_number(mag)
    shift = torch.where(seg < 2, 4, seg + 3)
    aval = (seg << 4) | ((mag >> shift) & 0xF)
    code = torch.where(seg >= 8, 0x7F, aval) ^ mask
    return code.to(torch.uint8)


def alaw_to_linear(code):
    """uint8 A-law -> int16 linear PCM (g711.c:149-173 semantics)."""
    a = code.to(torch.int32) ^ 0x55
    t = (a & 0xF) << 4
    seg = (a & 0x70) >> 4
    t = torch.where(seg == 0, t + 8, (t + 0x108) << (seg - 1).clamp(min=0))
    return torch.where((a & 0x80) != 0, t, -t).to(torch.int16)


def linear_to_ulaw(pcm):
    """int16 linear PCM -> uint8 mu-law (g711.c:205-236 semantics)."""
    x = pcm.to(torch.int32)
    neg = x < 0
    mask = torch.where(neg, 0x7F, 0xFF)
    mag = torch.where(neg, _BIAS - x, x + _BIAS)
    seg = _seg_number(mag)
    uval = (seg << 4) | ((mag >> (seg + 3)) & 0xF)
    code = torch.where(seg >= 8, 0x7F, uval) ^ mask
    return code.to(torch.uint8)


def ulaw_to_linear(code):
    """uint8 mu-law -> int16 linear PCM (g711.c:247-264 semantics)."""
    u = (~code.to(torch.int32)) & 0xFF
    t = (((u & 0xF) << 3) + _BIAS) << ((u & 0x70) >> 4)
    return torch.where((u & 0x80) != 0, _BIAS - t, t - _BIAS).to(torch.int16)


def alaw_to_ulaw(code):
    """Direct A-law -> mu-law transcode (composition; g711.c:276-300 analog)."""
    return linear_to_ulaw(alaw_to_linear(code))


def ulaw_to_alaw(code):
    """Direct mu-law -> A-law transcode."""
    return linear_to_alaw(ulaw_to_linear(code))


class _ElementwiseCodec(Block):
    _fn = None

    def apply(self, state, x):
        return state, type(self)._fn(x)


class AlawEncode(_ElementwiseCodec):
    """vocoder_alaw_encode_sb: int16 PCM stream -> A-law byte stream."""
    in_ports = (port_s(),)
    out_ports = (port_b(),)
    _fn = staticmethod(linear_to_alaw)


class AlawDecode(_ElementwiseCodec):
    """vocoder_alaw_decode_bs: A-law byte stream -> int16 PCM stream."""
    in_ports = (port_b(),)
    out_ports = (port_s(),)
    _fn = staticmethod(alaw_to_linear)


class UlawEncode(_ElementwiseCodec):
    """vocoder_ulaw_encode_sb: int16 PCM stream -> mu-law byte stream."""
    in_ports = (port_s(),)
    out_ports = (port_b(),)
    _fn = staticmethod(linear_to_ulaw)


class UlawDecode(_ElementwiseCodec):
    """vocoder_ulaw_decode_bs: mu-law byte stream -> int16 PCM stream."""
    in_ports = (port_b(),)
    out_ports = (port_s(),)
    _fn = staticmethod(ulaw_to_linear)
