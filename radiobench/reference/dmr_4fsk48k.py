"""Plain reference of config #4, DMR 4FSK at 48 kS/s: quadrature demod
-> matched root-raised-cosine filter -> Mueller & Muller clock recovery
with the 8-tap MMSE interpolator -> four-level slicer, over a continuous
channel.

Plain PyTorch for the filters (float64 convolutions on whatever device
holds the samples) and a Python loop for the clock recovery.  It imports
nothing of the program: the taps and the interpolator bank come from
``designs``, the loop's state starts as the configuration states it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from radiobench.reference import designs
from radiobench.reference.precision import tf32

PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}
THRESHOLDS = (-2 / 3, 0.0, 2 / 3)
# A decision counts where the reference's soft symbol lies farther than this
# from every threshold: one nearer is decided by rounding (float32 moves a
# level by ~1e-6, an interpolator phase picked one step apart by ~2e-3),
# not by the receiver; the levels' own gap is held by level_err_median.
CLEAR = 0.01


def _sens(cfg: dict) -> float:
    fs = cfg["samples_per_symbol"] * cfg["symbol_rate"]
    return 2 * math.pi * cfg["deviation_hz"] / fs


def matched(cfg: dict, x: torch.Tensor, dt) -> torch.Tensor:
    """(rows, n) complex -> (rows, n) levels (nominally +-1/3, +-1): the
    discriminator scaled by 1 / sensitivity (x[-1] = 0), the RRC at unit
    energy divided by sps, zero history."""
    sps = cfg["samples_per_symbol"]
    xr, xi = x.real.to(dt), x.imag.to(dt)
    pr, pi = torch.zeros_like(xr), torch.zeros_like(xi)
    pr[:, 1:] = xr[:, 1:] * xr[:, :-1] + xi[:, 1:] * xi[:, :-1]
    pi[:, 1:] = xi[:, 1:] * xr[:, :-1] - xr[:, 1:] * xi[:, :-1]
    fm = torch.atan2(pi, pr) / _sens(cfg)
    h = designs.rrc(1.0, sps, 1.0, cfg["rrc_alpha"], cfg["rrc_taps"]) / sps
    h = torch.from_numpy(h[::-1].copy()).to(x.device, dt)
    if dt == torch.float32:       # the control: the operands in TF32
        fm, h = tf32(fm), tf32(h)
    return F.conv1d(F.pad(fm[:, None], (len(h) - 1, 0)), h[None, None])[:, 0]


def slice4(v: np.ndarray) -> np.ndarray:
    """Levels +-1/3, +-1 -> dibits 01 (+1), 00 (+1/3), 10 (-1/3), 11 (-1)."""
    return np.where(v > 2 / 3, 1, np.where(v > 0, 0, np.where(v > -2 / 3, 2, 3))
                    ).astype(np.uint8)


def clock_recovery(cfg: dict, mf: np.ndarray, precision: str) -> np.ndarray:
    """M&M over a whole stream (one level a symbol).  The interpolator reads
    8 samples from floor(base) at phase round(128 mu); the loop starts at
    mu = 0.5, omega = sps, a last sample of 0, ``history - 1`` zero samples
    before the stream (the block's history: 8 taps + ceil(sps) + 3)."""
    mm = cfg["clock_recovery"]
    f = float if precision == "float64" else np.float32
    sps = cfg["samples_per_symbol"]
    lead = 8 + math.ceil(sps) + 3 - 1
    x = [f(v) for v in np.concatenate([np.zeros(lead), mf])]
    bank = [[f(v) for v in row] for row in designs.mmse_bank()]
    g_mu = f(mm["gain_mu"])
    g_om = f(0.25 * mm["gain_mu"] ** 2)
    lo = f(sps - sps * mm["omega_relative_limit"])
    hi = f(sps + sps * mm["omega_relative_limit"])
    one, mone, zero = f(1.0), f(-1.0), f(0.0)
    mu, omega, base, last = f(mm["mu"]), f(sps), 0, zero
    out = []
    n = len(x)
    while base + 8 <= n:
        w = bank[int(np.round(mu * 128))]
        win = x[base:base + 8]
        samp = zero
        for k in range(8):
            samp = samp + win[k] * w[k]
        err = (one if last > 0 else mone) * samp - (one if samp > 0 else mone) * last
        omega = min(max(omega + g_om * err, lo), hi)
        step = mu + omega + g_mu * err
        fl = math.floor(step)
        if base + fl + 8 > n:
            break
        base += fl
        mu = step - f(fl)
        last = samp
        out.append(samp)
    return np.array(out, np.float64)


def stream_levels(cfg: dict, x: torch.Tensor, precision: str = "float64") -> np.ndarray:
    dt = PRECISIONS[precision]
    mf = matched(cfg, x[None], dt)[0].cpu().numpy()
    return clock_recovery(cfg, mf, precision)


def _stream_input(mix, sources, plan, n_requests):
    parts = []
    for r in range(n_requests):
        src, at = plan.slot(r)
        parts.append(sources[src, 0, at:at + mix["request_samples"]])
    return torch.cat(parts)


def dibit_errors(got_d: np.ndarray, want_v: np.ndarray) -> int:
    """Dibits that differ from the reference's clear decisions (``CLEAR``)."""
    clear = np.min(np.abs(want_v[..., None] - np.array(THRESHOLDS)), axis=-1) > CLEAR
    return int(((got_d != slice4(want_v)) & clear).sum())


def _numbers(got_d, got_v, want_v):
    """(dibit errors, the median |level gap|) over the symbols both have."""
    n = min(len(got_d), len(got_v), len(want_v))
    errors = dibit_errors(got_d[:n], want_v[:n])
    gap = float(np.median(np.abs(got_v[:n] - want_v[:n]))) if n else float("inf")
    return errors, gap


def compare(cfg: dict, mix: dict, sources, plan, outputs: dict,
            n_requests: int) -> dict:
    """The numbers compared, over every symbol of the stream (the traffic
    keeps every request's output: the stream is fed from the first request
    on):

    - ``dibit_errors``: the program's dibits that differ from the
      reference's clear decisions (``CLEAR``);
    - ``dibit_count_gap``: symbols the program gave more or fewer than the
      reference (a stream's last chunk may hold back up to two symbols it
      cannot finish, which are not counted);
    - ``level_err_median``: the median over symbols of the gap between the
      program's soft symbol and the reference's (levels +-1/3, +-1), which
      moves with the precision of every symbol, where decisions move only
      at the rare symbol next to a threshold."""
    want = stream_levels(cfg, _stream_input(mix, sources, plan, n_requests))
    got_d = np.concatenate([np.asarray(outputs[r][0]).reshape(-1)
                            for r in range(n_requests)])
    got_v = np.concatenate([np.asarray(outputs[r][1]).reshape(-1)
                            for r in range(n_requests)])
    errors, med = _numbers(got_d, got_v, want)
    short = len(want) - len(got_d)
    gap = max(0, short - 2) if short >= 0 else -short
    return {"dibit_errors": errors,
            "dibit_count_gap": gap + abs(len(got_v) - len(got_d)),
            "level_err_median": med}


def control(cfg: dict, mix: dict, sources, plan, kept, n_requests: int) -> dict:
    """The reference in the program's place at the precision below the
    configuration's: float32, the matched filter's operands in TF32, the
    loop in float32.  The whole stream's symbols stand as the first
    request's output (the comparison joins the requests' outputs again)."""
    v = stream_levels(cfg, _stream_input(mix, sources, plan, n_requests), "tf32")
    empty = (np.zeros(0, np.uint8), np.zeros(0, np.float32))
    return {0: (slice4(v), v), **{r: empty for r in range(1, n_requests)}}
