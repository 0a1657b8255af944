"""Filter blocks (port of ``grtpu.blocks.filter``).

Analogs: gr_fir_filter_XXX, gr_interp_fir_filter_XXX,
gr_fft_filter_{ccc,fff}, gr_iir_filter_ffd, gr_single_pole_iir_filter_ff.  Each block binds a ``grtpu_torch.ops``
function into the Block protocol: history = ntaps so the executor supplies
the halo.  Taps stay host numpy arrays (as in grtpu); each block keeps one
copy per device it has run on, so a step moves no taps to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.ops import cuda_fir, dsp
from grtpu_torch.ops.fft_filter import fft_filter as _fftfir
from grtpu_torch.ops.fir import as_taps, fir_filter as _fir
from grtpu_torch.ops.fir import interp_fir_filter as _ifir


def _dt(tag):
    return {"f": torch.float32, "c": torch.complex64, "s": torch.int16}[tag]


class FirFilter(Block):
    """Decimating FIR (gr_fir_filter_XXX).  sig: 'fff', 'ccf', 'ccc', 'fcc',
    'scc', 'fsf' type triplets (in, out, taps).

    ``impl`` takes grtpu's values: "mxu" (Toeplitz matmul), "fft"
    (overlap-save), "auto" (fft for >= 128 taps at decimation 1, else mxu,
    as in grtpu) and "kernel" — the hand-written Hopper kernel of
    :mod:`grtpu_torch.ops.cuda_fir` at its default bf16x3 precision, for
    fff/ccf/ccc streams.  "pallas" is accepted as an alias of "kernel", so a
    graph written for grtpu builds unchanged."""

    def __init__(self, decimation: int, taps, sig: str = "fff", name=None,
                 impl: str = "auto"):
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(_dt(out_t)),)
        taps = np.asarray(taps)
        self.decim = decimation
        self.history = len(taps)
        super().__init__(name)
        self.taps = np.asarray(
            taps, np.complex64 if tap_t == "c" else np.float32)
        self._taps_dev = {}
        if impl == "auto":
            impl = "fft" if len(taps) >= 128 and decimation == 1 else "mxu"
        if impl == "pallas":
            impl = "kernel"
        if impl not in ("mxu", "fft", "kernel"):
            raise ValueError(f"unknown impl {impl!r}")
        if impl == "kernel" and sig not in ("fff", "ccf", "ccc"):
            raise ValueError("impl='kernel' supports fff/ccf/ccc streams "
                             "(the kernel works on f32 planes)")
        self.impl = impl
        self._sig = sig
        self._out_cast = _dt(out_t)

    def _taps_on(self, device) -> torch.Tensor:
        t = self._taps_dev.get(device)
        if t is None:
            t = self._taps_dev[device] = as_taps(self.taps, device)
        return t

    def apply(self, state, x):
        taps = self._taps_on(x.device)
        if self.impl == "kernel":
            if self._sig == "fff":
                y = cuda_fir.fir_decim(x, taps, self.decim)
            elif self._sig == "ccf":
                y = cuda_fir.fir_decim_c(x, taps, self.decim)
            else:  # ccc
                y = cuda_fir.fir_decim_cc(x, taps, self.decim)
            return state, y.to(self._out_cast)
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        f = _fftfir if self.impl == "fft" else _fir
        y = f(x, taps, self.decim)
        if self._out_cast == torch.int16:
            y = torch.clamp(torch.round(y), -32768, 32767)
        return state, y.to(self._out_cast)

    def set_taps(self, taps):
        if len(taps) != self.history:
            raise ValueError("set_taps must preserve tap count (history)")
        self.taps = np.asarray(taps, self.taps.dtype)
        self._taps_dev = {}
        self.touch()  # invalidate any built executor (stale-taps guard)


class FftFilter(FirFilter):
    """gr_fft_filter_{ccc,fff}: same contract, FFT path forced."""

    def __init__(self, decimation: int, taps, sig: str = "ccc", name=None):
        super().__init__(decimation, taps, sig, name, impl="fft")


class InterpFirFilter(Block):
    """Polyphase interpolating FIR (gr_interp_fir_filter_XXX)."""

    def __init__(self, interpolation: int, taps, sig: str = "fff", name=None):
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(_dt(out_t)),)
        taps = np.asarray(taps)
        self.interp = interpolation
        self.history = -(-len(taps) // interpolation)  # taps per phase
        super().__init__(name)
        self.taps = np.asarray(
            taps, np.complex64 if tap_t == "c" else np.float32)
        self._taps_dev = {}

    def apply(self, state, x):
        taps = self._taps_dev.get(x.device)
        if taps is None:
            taps = self._taps_dev[x.device] = as_taps(self.taps, x.device)
        return state, _ifir(x, taps, self.interp).to(self.out_ports[0].dtype)


class IirFilter(Block):
    """gr_iir_filter_ffd."""

    def __init__(self, fftaps, fbtaps, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)
        self.ff = np.asarray(fftaps, np.float32)
        self.fb = np.asarray(fbtaps, np.float32)
        self._ff_dev = {}

    def init_state(self):
        return dsp.iir_init_state(len(self.ff), len(self.fb))

    def apply(self, state, x):
        ff = self._ff_dev.get(x.device)
        if ff is None:
            ff = self._ff_dev[x.device] = as_taps(self.ff, x.device)
        y, st = dsp.iir_filter(x, state, ff, self.fb)
        return st, y


class SinglePoleIir(Block):
    """gr_single_pole_iir_filter_ff."""

    def __init__(self, alpha: float, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.alpha = alpha
        self._dtype = self.in_ports[0].dtype

    def init_state(self):
        return torch.zeros((), dtype=self._dtype)

    def apply(self, state, x):
        y, st = dsp.single_pole_iir(x, state, self.alpha)
        return st, y
