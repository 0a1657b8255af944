"""Plain reference of config #1 in full: a 2.048 MS/s complex capture ->
the frequency-translating tuner (``gr_freq_xlating_fir_filter_ccf``) ->
``wfm_rcv``.

The tuner as the source runs it: the prototype low-pass pre-rotated to the
centre frequency, a decimating convolution, and each output turned by the
rotator.  Here the convolution is float64 PyTorch, and output g (counted
from the stream's first sample, every request since the first warm-up one
included) is turned by the exact phase -2 pi ((f_c D g) mod f_s) / f_s,
worked out in integers: ``gr_rotator`` holds its phasor to float32's
rounding at every output, over any length of stream.  The rest is the WBFM
receiver's reference (``wbfm_rcv256.demod_audio``) at the quadrature rate.
It imports nothing of the program.

The check starts ``prefix_samples`` before each kept request, on the
samples the program was given there, as the WBFM reference does: the
prefix fills the tuner's and every later history.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radiobench.reference import designs
from radiobench.reference import wbfm_rcv256 as rcv


def tuner_taps(cfg: dict) -> np.ndarray:
    """The prototype low-pass turned to the centre frequency, complex128:
    h[k] exp(j 2 pi ((f_c k) mod f_s) / f_s)."""
    t, fs = cfg["tuner"], int(cfg["capture_rate"])
    h = designs.low_pass(1.0, fs, t["cutoff_hz"], t["transition_hz"])
    k = np.arange(len(h), dtype=np.int64)
    turn = (int(t["center_hz"]) * k) % fs
    return h * np.exp(2j * math.pi * turn / fs)


def rotator(cfg: dict, g0: int, n: int, device) -> torch.Tensor:
    """float64 phases of outputs g0 .. g0 + n - 1:
    -2 pi ((f_c D g) mod f_s) / f_s, the product reduced in integers."""
    t, fs = cfg["tuner"], int(cfg["capture_rate"])
    step = (int(t["center_hz"]) * int(t["decimation"])) % fs
    g = torch.arange(n, dtype=torch.int64, device=device) + g0
    turn = (step * torch.remainder(g, fs)) % fs
    return -2 * math.pi * turn.to(torch.float64) / fs


def tune(cfg: dict, x: torch.Tensor, g0: int, precision: str = "float64"):
    """The tuner's output (re, im) at the quadrature rate for the stream
    ``x`` (zero history before it), whose first output is output ``g0``."""
    dt = rcv.PRECISIONS[precision]
    d = int(cfg["tuner"]["decimation"])
    h = torch.from_numpy(tuner_taps(cfg)).to(x.device)
    hr, hi = h.real.to(dt), h.imag.to(dt)
    xr, xi = x.real.to(dt)[None], x.imag.to(dt)[None]
    yr = rcv.fir(xr, hr, d)[0] - rcv.fir(xi, hi, d)[0]
    yi = rcv.fir(xr, hi, d)[0] + rcv.fir(xi, hr, d)[0]
    ph = rotator(cfg, g0, yr.shape[0], x.device)
    c, s = torch.cos(ph).to(dt), torch.sin(ph).to(dt)
    # + 0.0 makes the zero history's -0.0 a +0.0: the discriminator's atan2
    # reads the sign of a zero (atan2(0, -0) is pi)
    return yr * c - yi * s + 0.0, yr * s + yi * c + 0.0


def request_audio(cfg: dict, mix: dict, sources: torch.Tensor, plan, r: int,
                  precision: str = "float64") -> np.ndarray:
    """Request ``r``'s audio: the tuner and the receiver from
    ``prefix_samples`` before the request's first sample."""
    d = int(cfg["tuner"]["decimation"])
    p, n = mix["prefix_samples"], mix["request_samples"]
    x = rcv.prefixed(mix, sources, plan, r)
    yr, yi = tune(cfg, x, (r * n - p) // d, precision)
    a = rcv.demod_audio(cfg, yr, yi, precision)
    return a[p // (d * cfg["audio_decimation"]):]


def compare(cfg: dict, mix: dict, sources, plan, outputs: dict,
            n_requests: int) -> dict:
    return rcv.audio_numbers(
        outputs, lambda r: request_audio(cfg, mix, sources, plan, r))


def control(cfg: dict, mix: dict, sources, plan, kept, n_requests: int) -> dict:
    """The reference in the program's place at the precision below the
    configuration's: float32, every convolution's operands in TF32."""
    return {r: request_audio(cfg, mix, sources, plan, r, "tf32") for r in kept}
