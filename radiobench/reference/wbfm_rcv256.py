"""Plain reference of the WBFM receiver, ``wfm_rcv``: a complex capture at
the quadrature rate -> quadrature demod -> the decimating audio FIR (the
source's Hamming low-pass) -> de-emphasis.

Plain PyTorch (convolutions in float64 on whatever device holds the
samples) and SciPy's ``lfilter`` for the de-emphasis.  It imports nothing
of the program: taps and filter state are worked out here.

The check.  A request's audio depends on the state the stream left: the
demod's last sample, the audio FIR's history and the de-emphasis pole.  The
reference starts ``prefix_samples`` before the request, on the samples the
program was given there, which fills every history (the pole decays below
1e-100 within the prefix).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import lfilter

from radiobench.reference import designs
from radiobench.reference.precision import tf32

PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}


def audio_taps(cfg: dict) -> np.ndarray:
    a = cfg["audio_filter"]
    return designs.low_pass(1.0, cfg["quad_rate"], a["cutoff_hz"],
                            a["transition_hz"])


def fir(x: torch.Tensor, h: torch.Tensor, decim: int) -> torch.Tensor:
    """y[i] = sum_k h[k] x[decim i - k], zero history; x (rows, n).  In
    float32 (the control) the operands are rounded to TF32."""
    if x.dtype == torch.float32:
        x, h = tf32(x), tf32(h)
    k = h.shape[-1]
    return F.conv1d(F.pad(x[:, None], (k - 1, 0)), h.flip(-1)[None, None],
                    stride=decim)[:, 0]


def demod_audio(cfg: dict, yr: torch.Tensor, yi: torch.Tensor,
                precision: str = "float64") -> np.ndarray:
    """Audio of the baseband ``yr + j yi`` (at the quadrature rate, from
    zero state) in ``precision``."""
    dt = PRECISIONS[precision]
    # y[i] * conj(y[i - 1]), y[-1] = 0
    pr, pi = torch.zeros_like(yr), torch.zeros_like(yi)
    pr[1:] = yr[1:] * yr[:-1] + yi[1:] * yi[:-1]
    pi[1:] = yi[1:] * yr[:-1] - yr[1:] * yi[:-1]
    gain = cfg["quad_rate"] / (2 * math.pi * cfg["max_deviation_hz"])
    q = gain * torch.atan2(pi, pr)
    h = torch.from_numpy(audio_taps(cfg)).to(yr.device, dt)
    a = fir(q[None], h, cfg["audio_decimation"])[0]
    host = np.float64 if precision == "float64" else np.float32
    a = a.cpu().numpy().astype(host)
    b0, p1 = designs.deemphasis(cfg["quad_rate"] / cfg["audio_decimation"],
                                cfg["deemphasis_tau"])
    return lfilter(np.array([b0, b0], host), np.array([1.0, -p1], host), a)


def prefixed(mix: dict, sources: torch.Tensor, plan, r: int) -> torch.Tensor:
    """Request ``r``'s samples after the ``prefix_samples`` fed before it
    (zeros before the first request)."""
    n, p = mix["request_samples"], mix["prefix_samples"]
    src, at = plan.slot(r)
    x = sources[src, 0, at:at + n]
    if r == 0:
        prev = torch.zeros(p, dtype=x.dtype, device=x.device)
    else:
        psrc, pat = plan.slot(r - 1)
        prev = sources[psrc, 0, pat + n - p:pat + n]
    return torch.cat([prev, x])


def request_audio(cfg: dict, mix: dict, sources: torch.Tensor, plan, r: int,
                  precision: str = "float64") -> np.ndarray:
    x = prefixed(mix, sources, plan, r)
    dt = PRECISIONS[precision]
    y = demod_audio(cfg, x.real.to(dt), x.imag.to(dt), precision)
    return y[mix["prefix_samples"] // cfg["audio_decimation"]:]


def audio_numbers(outputs: dict, want) -> dict:
    """The numbers compared: ``audio_err``, the largest gap between the
    program's audio and the reference's (``want(r)``) over the kept
    requests, as a share of the reference's largest magnitude;
    ``bad_shape``, the kept requests whose audio has the wrong length or a
    value that is not finite."""
    worst, peak, bad = 0.0, 0.0, 0
    for r, got in outputs.items():
        w = want(r)
        got = np.asarray(got)
        if got.shape != w.shape or not np.isfinite(got).all():
            bad += 1
            continue
        worst = max(worst, float(np.abs(got - w).max()))
        peak = max(peak, float(np.abs(w).max()))
    return {"audio_err": worst / peak if peak else float("inf"),
            "bad_shape": bad}


def compare(cfg: dict, mix: dict, sources, plan, outputs: dict,
            n_requests: int) -> dict:
    return audio_numbers(
        outputs, lambda r: request_audio(cfg, mix, sources, plan, r))


def control(cfg: dict, mix: dict, sources, plan, kept, n_requests: int) -> dict:
    """The reference in the program's place at the precision below the
    configuration's: float32, the filter's operands in TF32."""
    return {r: request_audio(cfg, mix, sources, plan, r, "tf32") for r in kept}
