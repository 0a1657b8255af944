"""Type-conversion blocks (port of ``grtpu.blocks.convert``).

Analogs of gnuradio-core/src/lib/general type converters:
gr_complex_to_{float,real,imag,mag,mag_squared,arg}, gr_float_to_complex,
gr_{char,short,int,float}_to_* scaling converts, and interleaved-short <->
complex used by USRP-format captures.

The float -> integer converters round half to even and saturate at the
rails, as grtpu's do.
"""

from __future__ import annotations

import torch

from grtpu_torch.runtime.block import Block, Port

_I32_MAX = 2147483647


def _round_clip(v: torch.Tensor, lo: int, hi: int, dtype) -> torch.Tensor:
    return torch.clamp(torch.round(v), lo, hi).to(dtype)


class ComplexToFloat(Block):
    """gr_complex_to_float: 1 complex in -> (re, im) float outs."""

    def __init__(self, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.float32), Port(torch.float32))
        super().__init__(name)

    def apply(self, state, x):
        return state, (x.real, x.imag)


class _C2F(Block):
    def __init__(self, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)


class ComplexToReal(_C2F):
    def apply(self, state, x):
        return state, x.real


class ComplexToImag(_C2F):
    def apply(self, state, x):
        return state, x.imag


class ComplexToMag(_C2F):
    def apply(self, state, x):
        return state, torch.abs(x)


class ComplexToMagSquared(_C2F):
    def apply(self, state, x):
        return state, x.real ** 2 + x.imag ** 2


class ComplexToArg(_C2F):
    def apply(self, state, x):
        return state, torch.atan2(x.imag, x.real)


class FloatToComplex(Block):
    """gr_float_to_complex: (re[, im]) -> complex."""

    def __init__(self, nin: int = 2, name=None):
        self.in_ports = tuple(Port(torch.float32) for _ in range(nin))
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.nin = nin

    def apply(self, state, re, im=None):
        if im is None:
            im = torch.zeros_like(re)
        return state, torch.complex(re, im)


class _Scale(Block):
    def __init__(self, in_dtype, out_dtype, scale: float = 1.0, name=None):
        self.in_ports = (Port(in_dtype),)
        self.out_ports = (Port(out_dtype),)
        super().__init__(name)
        self.scale = scale
        self._out = self.out_ports[0].dtype


class FloatToShort(_Scale):
    def __init__(self, scale: float = 1.0, name=None):
        super().__init__(torch.float32, torch.int16, scale, name)

    def apply(self, state, x):
        return state, _round_clip(x * self.scale, -32768, 32767, torch.int16)


class FloatToChar(_Scale):
    def __init__(self, scale: float = 1.0, name=None):
        super().__init__(torch.float32, torch.int8, scale, name)

    def apply(self, state, x):
        return state, _round_clip(x * self.scale, -128, 127, torch.int8)


class FloatToUChar(_Scale):
    def __init__(self, name=None):
        super().__init__(torch.float32, torch.uint8, 1.0, name)

    def apply(self, state, x):
        return state, _round_clip(x, 0, 255, torch.uint8)


class FloatToInt(_Scale):
    def __init__(self, scale: float = 1.0, name=None):
        super().__init__(torch.float32, torch.int32, scale, name)

    def apply(self, state, x):
        # the cast saturates (the largest float32 below 2^31 is 2^31 - 128,
        # so the upper rail is set apart)
        r = torch.round(x * self.scale)
        y = torch.clamp(r, -2147483648.0, 2147483520.0).to(torch.int32)
        return state, torch.where(r >= 2147483648.0,
                                  torch.full_like(y, _I32_MAX), y)


class ShortToFloat(_Scale):
    def __init__(self, scale: float = 1.0, name=None):
        super().__init__(torch.int16, torch.float32, scale, name)

    def apply(self, state, x):
        return state, x.to(torch.float32) * self.scale


class CharToFloat(_Scale):
    def __init__(self, scale: float = 1.0, name=None):
        super().__init__(torch.int8, torch.float32, scale, name)

    def apply(self, state, x):
        return state, x.to(torch.float32) * self.scale


class UCharToFloat(_Scale):
    def __init__(self, name=None):
        super().__init__(torch.uint8, torch.float32, 1.0, name)

    def apply(self, state, x):
        return state, x.to(torch.float32)


class IntToFloat(_Scale):
    def __init__(self, scale: float = 1.0, name=None):
        super().__init__(torch.int32, torch.float32, scale, name)

    def apply(self, state, x):
        return state, x.to(torch.float32) * self.scale


class InterleavedShortToComplex(Block):
    """gr_interleaved_short_to_complex: (I, Q) int16 pairs -> complex."""

    def __init__(self, scale: float = 1.0, name=None):
        self.in_ports = (Port(torch.int16),)
        self.out_ports = (Port(torch.complex64),)
        self.decim = 2
        super().__init__(name)
        self.scale = scale

    def apply(self, state, x):
        g = x.reshape(-1, 2).to(torch.float32) * self.scale
        return state, torch.complex(g[:, 0], g[:, 1])


class ComplexToInterleavedShort(Block):
    """gr_complex_to_interleaved_short."""

    def __init__(self, scale: float = 1.0, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.int16),)
        self.interp = 2
        super().__init__(name)
        self.scale = scale

    def apply(self, state, x):
        iq = torch.stack([x.real, x.imag], dim=1) * self.scale
        return state, _round_clip(iq, -32768, 32767, torch.int16).reshape(-1)


class Conjugate(Block):
    """gr_conjugate_cc."""

    in_ports = (Port(torch.complex64),)
    out_ports = (Port(torch.complex64),)

    def apply(self, state, x):
        return state, torch.conj(x).resolve_conj()


class CharToFloatSigned(Block):
    """gr_char_to_float over the canonical uint8 byte streams: bytes are
    reinterpreted as signed chars (the reference connects char/uchar streams
    interchangeably by itemsize; ports here are dtype-strict)."""

    in_ports = (Port(torch.uint8),)
    out_ports = (Port(torch.float32),)

    def apply(self, state, x):
        v = x.to(torch.float32)
        return state, torch.where(v < 128.0, v, v - 256.0)


class FloatToCharSigned(Block):
    """gr_float_to_char emitting the canonical uint8 bytes (two's
    complement view of the clipped signed value)."""

    in_ports = (Port(torch.float32),)
    out_ports = (Port(torch.uint8),)

    def apply(self, state, x):
        v = torch.clamp(torch.round(x), -128, 127)
        return state, torch.where(v < 0, v + 256.0, v).to(torch.uint8)


class Cast(Block):
    """Generic dtype cast (no scaling) — glue for flowgraphs whose stream
    types differ from a block's native ports."""

    def __init__(self, in_dtype, out_dtype, name=None):
        self.in_ports = (Port(in_dtype),)
        self.out_ports = (Port(out_dtype),)
        super().__init__(name)

    def apply(self, state, x):
        out = self.out_ports[0].dtype
        if x.is_complex() and not out.is_complex:
            x = x.real
        return state, x.to(out)
