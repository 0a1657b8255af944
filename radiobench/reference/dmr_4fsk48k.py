"""Plain reference of config #4, DMR 4FSK at 48 kS/s: quadrature demod
-> matched root-raised-cosine filter -> Mueller & Muller clock recovery
with the 8-tap MMSE interpolator -> four-level slicer, over a continuous
channel.

Plain PyTorch for the filters (float64 convolutions on whatever device
holds the samples) and the clock recovery as compiled C (``mm_loop.c``),
held bit for bit to the Python loop ``clock_recovery``, which defines it.
The stream is walked in pieces of whole requests, so that the check's
memory is bounded by the piece and its time grows at compiled speed with
the requests a window serves.  It imports nothing of the program: the taps
and the interpolator bank come from ``designs``, the loop's state starts as
the configuration states it.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

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
# The stream is walked in pieces of whole requests of at most this many
# samples; the numbers are worked out in blocks of this many symbols.
PIECE_SAMPLES = 1 << 22
BLOCK = 1 << 22

MM_SOURCE = Path(__file__).with_name("mm_loop.c")
# No contraction: a fused multiply-add rounds differently from the Python loop.
MM_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
COMPILERS = ("cc", "gcc", "clang")
# The checkout's fixed build directory (``radiobench/run.py`` puts its
# caches there too), so that only a checkout's first check compiles.
BUILD = Path(__file__).resolve().parents[2] / "build" / "radiobench"


def _sens(cfg: dict) -> float:
    fs = cfg["samples_per_symbol"] * cfg["symbol_rate"]
    return 2 * math.pi * cfg["deviation_hz"] / fs


DIBITS = np.array([3, 2, 0, 1], np.uint8)    # by thresholds below the level


def slice4(v: np.ndarray) -> np.ndarray:
    """Levels +-1/3, +-1 -> dibits 01 (+1), 00 (+1/3), 10 (-1/3), 11 (-1):
    above 2/3, above 0, above -2/3, the rest (NaN too)."""
    above = [(v > t).view(np.uint8) for t in THRESHOLDS]
    return DIBITS[above[0] + above[1] + above[2]]


def clock_recovery(cfg: dict, mf: np.ndarray, precision: str) -> np.ndarray:
    """M&M over a whole stream (one level a symbol).  The interpolator reads
    8 samples from floor(base) at phase round(128 mu); the loop starts at
    mu = 0.5, omega = sps, a last sample of 0, ``history - 1`` zero samples
    before the stream (the block's history: 8 taps + ceil(sps) + 3).

    The definition that ``mm_loop.c`` is held to; the check runs that."""
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


def mm_library() -> ctypes.CDLL:
    """``mm_loop.c`` built with the system C compiler into ``BUILD`` (once
    a checkout: the file's name holds the source's and the flags' hash),
    its two loops typed.  Raises, naming the compilers looked for, where
    there is none: the check does not fall back to the Python loop."""
    key = hashlib.sha256(MM_SOURCE.read_bytes() + " ".join(MM_FLAGS).encode())
    lib = BUILD / f"mm_loop-{key.hexdigest()[:16]}.so"
    if not lib.exists():
        cc = next(filter(None, map(shutil.which, COMPILERS)), None)
        if cc is None:
            raise RuntimeError(
                f"radiobench: no C compiler found ({', '.join(COMPILERS)} on "
                f"PATH); the DMR reference's M&M loop is {MM_SOURCE.name}, "
                "compiled at the check")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        p = subprocess.run([cc, *MM_FLAGS, "-o", str(tmp), str(MM_SOURCE), "-lm"],
                           capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"radiobench: {cc} failed on {MM_SOURCE}:\n{p.stderr}")
        os.replace(tmp, lib)    # whole or not at all, for a concurrent check
    so = ctypes.CDLL(str(lib))
    for name, dt, ct in (("mm_f64", np.float64, ctypes.c_double),
                         ("mm_f32", np.float32, ctypes.c_float)):
        arr = np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
        fn = getattr(so, name)
        fn.argtypes = [arr, ctypes.c_long, ctypes.POINTER(ctypes.c_long), arr, arr,
                       ct, ct, ct, ct, arr, ctypes.c_long]
        fn.restype = ctypes.c_long
    return so


class Stream:
    """The reference over one continuous stream that arrives in pieces:
    ``feed`` takes a piece's samples and returns the levels of the symbols
    it completes.  Between pieces it keeps the discriminator's last input
    sample, the matched filter's history and the loop's state (its samples
    from ``base`` on, mu, omega and the last level), so that a stream fed
    in any pieces gives the levels of the whole stream fed at once, up to
    the rounding of the convolution on pieces of another length."""

    def __init__(self, cfg: dict, precision: str, device):
        self.cfg = cfg
        self.dt = PRECISIONS[precision]
        f = np.float64 if precision == "float64" else np.float32
        sps = cfg["samples_per_symbol"]
        h = designs.rrc(1.0, sps, 1.0, cfg["rrc_alpha"], cfg["rrc_taps"]) / sps
        self.h = torch.from_numpy(h[::-1].copy()).to(device, self.dt)
        if self.dt == torch.float32:      # the control: the operands in TF32
            self.h = tf32(self.h)
        self.prev = None                  # the last input sample
        self.hist = torch.zeros(len(h) - 1, dtype=self.dt, device=device)
        mm = cfg["clock_recovery"]
        self.tail = np.zeros(8 + math.ceil(sps) + 3 - 1, f)
        self.state = np.array([mm["mu"], sps, 0.0], f)
        self.gains = [float(f(v)) for v in (
            mm["gain_mu"], 0.25 * mm["gain_mu"] ** 2,
            sps - sps * mm["omega_relative_limit"],
            sps + sps * mm["omega_relative_limit"])]
        self.bank = np.ascontiguousarray(designs.mmse_bank(), f)
        lib = mm_library()
        self.loop = lib.mm_f64 if f is np.float64 else lib.mm_f32

    def matched(self, x: torch.Tensor) -> np.ndarray:
        """(n,) complex -> (n,) levels (nominally +-1/3, +-1) on the host:
        the discriminator scaled by 1 / sensitivity (x[-1] = 0 at the
        stream's start), the RRC at unit energy divided by sps (zero
        history at the stream's start)."""
        first = self.prev is None
        xx = torch.cat([torch.zeros_like(x[:1]) if first else self.prev, x])
        xr, xi = xx.real.to(self.dt), xx.imag.to(self.dt)
        pr = xr[1:] * xr[:-1] + xi[1:] * xi[:-1]
        pi = xi[1:] * xr[:-1] - xr[1:] * xi[:-1]
        fm = torch.atan2(pi, pr) / _sens(self.cfg)
        if first:
            fm[0] = 0
        if self.dt == torch.float32:
            fm = tf32(fm)
        fm = torch.cat([self.hist, fm])
        self.prev, self.hist = x[-1:].clone(), fm[len(fm) - len(self.hist):].clone()
        return F.conv1d(fm[None, None], self.h[None, None])[0, 0].cpu().numpy()

    def feed(self, x: torch.Tensor) -> np.ndarray:
        """The levels (float64) of the symbols that the stream so far
        completes and earlier pieces did not."""
        return self.recover(self.matched(x))

    def recover(self, mf: np.ndarray) -> np.ndarray:
        """``feed`` after the matched filter: the compiled loop over the
        samples kept from earlier pieces and ``mf``."""
        buf = np.concatenate([self.tail, mf])
        base, out = ctypes.c_long(0), []
        while True:
            levels = np.empty(len(buf) // 8 + 1, buf.dtype)
            k = self.loop(buf, len(buf), ctypes.byref(base), self.state, self.bank,
                          *self.gains, levels, len(levels))
            if k < 0:
                raise RuntimeError("radiobench: the M&M loop stepped backwards")
            out.append(levels[:k])
            if k < len(levels):
                break
        self.tail = buf[base.value:].copy()
        return np.concatenate(out).astype(np.float64)


def _stream_input(mix, sources, plan, start, stop):
    """Requests ``start`` to ``stop - 1``'s samples, one after the other."""
    n = mix["request_samples"]
    return torch.cat([sources[src, 0, at:at + n]
                      for src, at in map(plan.slot, range(start, stop))])


def stream_pieces(cfg, mix, sources, plan, n_requests, precision="float64"):
    """The reference's levels of requests 0 to ``n_requests - 1`` as one
    stream, an array a piece of as many whole requests as ``PIECE_SAMPLES``
    holds (one at least)."""
    per = max(1, PIECE_SAMPLES // mix["request_samples"])
    walk = Stream(cfg, precision, sources.device)
    for start in range(0, n_requests, per):
        yield walk.feed(_stream_input(mix, sources, plan, start,
                                      min(start + per, n_requests)))


def dibit_errors(got_d: np.ndarray, want_v: np.ndarray) -> int:
    """Dibits that differ from the reference's clear decisions (``CLEAR``)."""
    errors = 0
    for i in range(0, len(want_v), BLOCK):
        w = want_v[i:i + BLOCK]
        near = np.abs(w - THRESHOLDS[0])
        for t in THRESHOLDS[1:]:
            np.minimum(near, np.abs(w - t), out=near)
        errors += int(((got_d[i:i + BLOCK] != slice4(w)) & (near > CLEAR)).sum())
    return errors


def _numbers(got_d, got_v, want_v):
    """(dibit errors, the median |level gap|) over the symbols both have."""
    n = min(len(got_d), len(got_v), len(want_v))
    errors = dibit_errors(got_d[:n], want_v[:n])
    if not n:
        return errors, float("inf")
    gap = np.empty(n)
    for i in range(0, n, BLOCK):
        j = min(i + BLOCK, n)
        np.abs(got_v[i:j] - want_v[i:j], out=gap[i:j])
    return errors, float(np.median(gap, overwrite_input=True))


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
    want = np.concatenate([np.zeros(0), *stream_pieces(
        cfg, mix, sources, plan, n_requests)])
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
    pieces = list(stream_pieces(cfg, mix, sources, plan, n_requests, "tf32"))
    d = np.concatenate([np.zeros(0, np.uint8), *map(slice4, pieces)])
    v = np.concatenate([np.zeros(0), *pieces])
    empty = (np.zeros(0, np.uint8), np.zeros(0, np.float32))
    return {0: (d, v), **{r: empty for r in range(1, n_requests)}}
