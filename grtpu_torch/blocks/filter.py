"""Filter blocks (port of ``grtpu.blocks.filter``).

Analogs: gr_fir_filter_XXX, gr_interp_fir_filter_XXX,
gr_rational_resampler_base_XXX, gr_freq_xlating_fir_filter_XXX,
gr_fft_filter_{ccc,fff}, gr_iir_filter_ffd, gr_single_pole_iir_filter_ff,
gr_dc_blocker_*, gr_hilbert_fc, gr_filter_delay_fc,
gr_fractional_interpolator, gr_goertzel_fc.  Each block binds a
``grtpu_torch.ops`` function into the Block protocol: history = ntaps so the
executor supplies the halo.  Taps stay host numpy arrays (as in grtpu); each block keeps one
copy per device it has run on, so a step moves no taps to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.ops import cuda_fir, dsp
from grtpu_torch.ops.fft_filter import fft_filter as _fftfir
from grtpu_torch.ops.fir import as_taps, fir_filter as _fir
from grtpu_torch.ops.fir import freq_xlating_fir_filter as _fx
from grtpu_torch.ops.fir import interp_fir_filter as _ifir
from grtpu_torch.ops.fir import phase_ramp, rotate_taps
from grtpu_torch.ops import mmse_interp
from grtpu_torch.utils import firdes


def _dt(tag):
    return {"f": torch.float32, "c": torch.complex64, "s": torch.int16}[tag]


class _TapsOnDevice:
    """Mixin: the block's host numpy taps (``self.taps``, or the attribute
    named by ``_taps_attr``) copied once to each device the block runs on."""

    _taps_attr = "taps"
    _taps_dev = None

    def _taps_on(self, device) -> torch.Tensor:
        if self._taps_dev is None:
            self._taps_dev = {}
        t = self._taps_dev.get(device)
        if t is None:
            t = self._taps_dev[device] = as_taps(
                getattr(self, self._taps_attr), device)
        return t


class FirFilter(_TapsOnDevice, Block):
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
        self._taps_dev = None
        self.touch()  # invalidate any built executor (stale-taps guard)


class FftFilter(FirFilter):
    """gr_fft_filter_{ccc,fff}: same contract, FFT path forced."""

    def __init__(self, decimation: int, taps, sig: str = "ccc", name=None):
        super().__init__(decimation, taps, sig, name, impl="fft")


class InterpFirFilter(_TapsOnDevice, Block):
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

    def apply(self, state, x):
        return state, _ifir(x, self._taps_on(x.device), self.interp).to(
            self.out_ports[0].dtype)


class RationalResampler(_TapsOnDevice, Block):
    """L/M resampler with anti-alias filter
    (gr_rational_resampler_base_XXX).  If taps is None a low-pass is
    designed automatically like blks2impl/rational_resampler.py."""

    def __init__(self, interpolation: int, decimation: int, taps=None,
                 sig: str = "fff", fractional_bw: float = 0.4, name=None):
        from math import gcd

        g = gcd(interpolation, decimation)
        interpolation //= g
        decimation //= g
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(_dt(out_t)),)
        self.interp = interpolation
        self.decim = decimation
        if taps is None:
            taps = self._design(interpolation, decimation, fractional_bw)
        taps = np.asarray(taps)
        self.history = -(-len(taps) // interpolation)
        super().__init__(name)
        self.taps = np.asarray(
            taps, np.complex64 if tap_t == "c" else np.float32)

    @staticmethod
    def _design(L, M, fractional_bw):
        """Auto tap design (blks2impl/rational_resampler.py design_filter)."""
        if fractional_bw >= 0.5 or fractional_bw <= 0:
            raise ValueError("fractional_bw must be in (0, 0.5)")
        beta = 7.0
        halfband = 0.5
        rate = L / M
        if rate >= 1.0:
            bw = halfband - fractional_bw
            tb = rate * (halfband - bw)
        else:
            bw = rate * halfband - rate * fractional_bw
            tb = rate * halfband - bw
        return firdes.low_pass(L, L, bw, tb, firdes.Window.KAISER, beta)

    def apply(self, state, x):
        up = _ifir(x, self._taps_on(x.device), self.interp)
        # x carries kp-1 history -> up has n*L aligned outputs; decimate.
        return state, up[::self.decim].to(self.out_ports[0].dtype)


class FreqXlatingFirFilter(_TapsOnDevice, Block):
    """gr_freq_xlating_fir_filter_XXX: band-select + translate + decimate.

    taps: real (or complex) prototype lowpass; center_freq/fs set the
    translation.  Carried state = rotator phase.  As in grtpu the filter is
    the plain matmul FIR with the rotated complex taps."""

    _taps_attr = "rtaps"

    def __init__(self, decimation: int, taps, center_freq: float,
                 sampling_freq: float, sig: str = "ccf", name=None):
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(torch.complex64),)
        taps = np.asarray(taps)
        self.decim = decimation
        self.history = len(taps)
        super().__init__(name)
        self.center_freq = center_freq
        self.fs = sampling_freq
        self.rtaps = rotate_taps(taps, center_freq, sampling_freq)
        self.phase_inc = -2 * np.pi * center_freq / sampling_freq

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        y, ph = _fx(x, self._taps_on(x.device), state, self.phase_inc,
                    self.decim)
        return ph, y


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


class _DelayedPair(_TapsOnDevice, Block):
    """float in -> complex out: the input delayed by the filter's group
    delay as the real part, the filtered input as the imaginary part."""

    def __init__(self, taps, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.complex64),)
        self.history = len(taps)
        super().__init__(name)
        self.taps = taps
        self.delay = (len(taps) - 1) // 2

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        q = _fir(x, self._taps_on(x.device), 1)
        return state, torch.complex(x[self.delay:self.delay + n], q)


class Hilbert(_DelayedPair):
    """gr_hilbert_fc: float in -> analytic signal out (delayed real +
    j*hilbert)."""

    def __init__(self, ntaps: int = 65, name=None):
        super().__init__(firdes.hilbert(ntaps | 1, firdes.Window.HAMMING),
                         name)


class FilterDelay(_DelayedPair):
    """gr_filter_delay_fc: (in, filtered(in)) as a complex pair with
    matched delay."""

    def __init__(self, taps, name=None):
        super().__init__(np.asarray(taps, np.float32), name)


class DcBlocker(Block):
    """gr_dc_blocker_{ff,cc}: moving-average DC removal with matched delay.

    long_form mirrors the reference's default (two cascaded length-D MAs)."""

    def __init__(self, d: int = 32, long_form: bool = True,
                 dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.d = d
        self.long_form = long_form
        # enough history for MA cascade + center delay
        self.history = (2 * d - 1 if long_form else d) + (d - 1)
        super().__init__(name)

    def _ma(self, x, d):
        c = torch.cumsum(x, dim=0)
        c = torch.cat([c.new_zeros((1,) + x.shape[1:]), c], dim=0)
        return (c[d:] - c[:-d]) / d

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        d = self.d
        acc = x.to(torch.complex64 if x.is_complex() else torch.float32)
        if self.long_form:
            ma = self._ma(self._ma(acc, d), d)  # len: n + d - 1
            delay = d - 1
        else:
            ma = self._ma(acc, d)
            delay = (d - 1) // 2
        # align input with the MA's group delay
        start = self.history - 1 - delay
        return state, x[start:start + n] - ma[ma.shape[0] - n:].to(x.dtype)


class Goertzel(Block):
    """gr_goertzel_fc: single-bin DFT per length-N batch."""

    def __init__(self, rate: int, batch_len: int, freq: float, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.complex64),)
        self.decim = batch_len
        super().__init__(name)
        self.k = freq * batch_len / rate
        self.n = batch_len

    def apply(self, state, x):
        xb = x.reshape(-1, self.n)
        ph = phase_ramp(0.0, -2 * np.pi * self.k / self.n, self.n, x.device)
        w = torch.complex(torch.cos(ph), torch.sin(ph))
        return state, (xb.to(torch.complex64) * w[None, :]).sum(dim=1)


class FractionalInterpolator(Block):
    """gr_fractional_interpolator_{ff,cc}: fixed fractional resampling via
    the 8-tap MMSE interpolator bank (gri_mmse_fir_interpolator).

    Static approximation: per-chunk output count is fixed at n/ratio, with
    the residual phase carried (matches the reference's steady-state rate)."""

    def __init__(self, phase_shift: float, interp_ratio: float,
                 dtype=torch.float32, name=None):
        from fractions import Fraction

        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        fr = Fraction(interp_ratio).limit_denominator(512)
        self.decim = fr.numerator
        self.interp = fr.denominator
        self.history = 9
        super().__init__(name)
        self.ratio = interp_ratio
        self.phase0 = phase_shift

    def apply(self, state, x):
        n_in = x.shape[0] - (self.history - 1)
        nout = n_in // self.decim * self.interp
        pos = phase_ramp(self.phase0, self.ratio, nout, x.device)
        y = mmse_interp.mmse_interpolate(x, pos)
        return state, y.to(self.out_ports[0].dtype)
