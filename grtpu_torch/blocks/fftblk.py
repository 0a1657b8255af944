"""FFT vector blocks + spectral models.

Port of ``grtpu.blocks.fftblk``.  Analogs: gri_fft / gr_fft_vcc (+_fftw),
gr_fft_vfc (vector-in/vector-out FFT with optional window + shift), and the
blks2impl spectral chains: logpwrfft.py (stream -> vector -> window FFT ->
|.|^2 -> log), stream_to_vector_decimator.py.  The FFTs are ``torch.fft``
(cuFFT on the card, which keeps its plans per shape).
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.runtime.graph import HierBlock
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import constant


class FftVcc(Block):
    """gr_fft_vcc: (vlen,) complex vectors -> FFT (or IFFT), optional
    window and spectral shift (DC-centered output)."""

    def __init__(self, fft_size: int, forward: bool = True, window=None,
                 shift: bool = False, name=None):
        self.in_ports = (Port(torch.complex64, fft_size),)
        self.out_ports = (Port(torch.complex64, fft_size),)
        super().__init__(name)
        self.fft_size = fft_size
        self.forward = forward
        self.window = None if window is None else np.asarray(window, np.float32)
        self.shift = shift

    def apply(self, state, x):
        v = x
        if self.window is not None:
            v = v * constant(self, "window", x.device)[None, :]
        if self.forward:
            y = torch.fft.fft(v, dim=1)
            if self.shift:
                y = torch.fft.fftshift(y, dim=1)
        else:
            if self.shift:
                v = torch.fft.ifftshift(v, dim=1)
            y = torch.fft.ifft(v, dim=1)
        return state, y.to(torch.complex64)


class FftVfc(Block):
    """gr_fft_vfc: float vectors -> complex FFT."""

    def __init__(self, fft_size: int, forward: bool = True, window=None,
                 shift: bool = False, name=None):
        self.in_ports = (Port(torch.float32, fft_size),)
        self.out_ports = (Port(torch.complex64, fft_size),)
        super().__init__(name)
        self.fft_size = fft_size
        self.window = None if window is None else np.asarray(window, np.float32)
        self.shift = shift
        self.forward = forward

    def apply(self, state, x):
        v = x if self.window is None else \
            x * constant(self, "window", x.device)[None, :]
        y = torch.fft.fft(v.to(torch.complex64), dim=1)
        if self.shift:
            y = torch.fft.fftshift(y, dim=1)
        return state, y.to(torch.complex64)


class StreamToVectorDecimator(Block):
    """blks2impl/stream_to_vector_decimator.py: group into vlen vectors,
    keep one vector in vec_rate (decimate at vector granularity)."""

    def __init__(self, vlen: int, keep_one_in: int = 1,
                 dtype=torch.complex64, name=None):
        self.in_ports = (Port(dtype, 1),)
        self.out_ports = (Port(dtype, vlen),)
        self.decim = vlen * keep_one_in
        super().__init__(name)
        self.vlen = vlen
        self.keep = keep_one_in

    def apply(self, state, x):
        v = x.reshape(-1, self.keep, self.vlen)
        return state, v[:, self.keep - 1, :]


class _Mag2Log(Block):
    """|X|^2 / window power in dB, per bin."""

    def __init__(self, fft_size: int, win_power: float):
        self.in_ports = (Port(torch.complex64, fft_size),)
        self.out_ports = (Port(torch.float32, fft_size),)
        super().__init__()
        self.win_power = win_power

    def apply(self, state, x):
        p = (x.real ** 2 + x.imag ** 2) / self.win_power
        return state, (10.0 * torch.log10(torch.clamp(p, min=1e-20))).to(
            torch.float32)


class LogPwrFft(HierBlock):
    """blks2impl/logpwrfft.py: stream -> windowed FFT -> 10*log10(|.|^2),
    with per-vector decimation derived from frame_rate.

    ``avg_alpha`` is accepted and, as in grtpu, not used: no averaging
    stage is built (the reference's logpwrfft inserts a single-pole
    average).  The port keeps grtpu's behaviour and adds no feature."""

    def __init__(self, sample_rate: float, fft_size: int = 1024,
                 frame_rate: float = 30.0, avg_alpha: float = 1.0,
                 dtype=torch.complex64, name=None):
        super().__init__(name)
        keep = max(1, int(sample_rate / (fft_size * frame_rate)))
        win = firdes.window(firdes.Window.BLACKMAN_HARRIS, fft_size)
        win_power = float((win ** 2).sum())
        i = self.graph.add_input(Port(dtype))
        o = self.graph.add_output(Port(torch.float32, fft_size))
        self.graph.connect(
            i, StreamToVectorDecimator(fft_size, keep, dtype),
            FftVcc(fft_size, True, win.astype(np.float32), shift=True),
            _Mag2Log(fft_size, win_power), o)
