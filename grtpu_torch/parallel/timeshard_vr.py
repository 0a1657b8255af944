"""Speculative time-sharding for a SINGLE variable-rate stream.

Port of ``grtpu.parallel.timeshard_vr``.  Closed-loop clock recovery is
sequential per stream, so one stream could never use more than one shard
(the mesh executor rejects time-sharding for variable-rate blocks).  The
speculative alternative for M&M clock recovery:

  1. split the stream into D overlapping spans (overlap >> the loop's
     acquisition time);
  2. run the windowed M&M on EVERY span from a cold state: the spans are
     independent, so they run as one batch
     (``grtpu_torch.digital.loops.clock_recovery_mm_ff_windowed`` on a
     (D, n) input), one batch a device of the mesh's ``time`` axis;
  3. reconcile at each boundary: by the end of span i and the start of
     span i+1's kept region both loops have converged to the same timing,
     up to an integer symbol-slot offset from span i+1's cold acquisition.
     The offset is recovered by correlating the overlap symbols, and the
     spans splice into one stream.

The splice is APPROXIMATE by design (the reference semantics are one
continuous loop); the guarantee is convergence-based: symbols outside each
span's settle region match the continuous loop's up to loop noise.
``time_sharded_mm`` returns the spliced symbols and per-boundary
diagnostics, so that callers can gate on the splice's quality.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from grtpu_torch.digital import loops
from grtpu_torch.utils.device import resolve


def _span_symbols(spans: torch.Tensor, sps, gain_omega, gain_mu,
                  omega_relative_limit, W) -> torch.Tensor:
    st = loops.mm_windowed_init_state(float(sps), 0.5, device=spans.device)
    st = loops.MMWinState(*(f.expand(spans.shape[0]).clone() for f in st))
    ys, _ = loops.clock_recovery_mm_ff_windowed(
        spans, st, sps, gain_omega, gain_mu, omega_relative_limit, W=W)
    return ys


def time_sharded_mm(x: np.ndarray, sps: float, gain_omega: float,
                    gain_mu: float, nshards: int,
                    overlap_syms: int = 512,
                    omega_relative_limit: float = 0.001, W: int = 32,
                    mesh=None, device=None) -> Tuple[np.ndarray, dict]:
    """M&M clock recovery of ONE stream across ``nshards`` time spans.

    x: raw samples (no history preload needed; spans self-pad).
    overlap_syms: per-boundary overlap in SYMBOLS; must comfortably cover
      the loop's acquisition (hundreds of symbols at typical gains).
    mesh: optional :class:`~grtpu_torch.parallel.mesh.Mesh` with a
      ``time`` axis: the spans split over it in order, each entry's spans
      one batch on its device (entries on one device make one batch).
      Without it the spans run as one batch on ``device`` (the card when
      not given).

    Returns (symbols, diag) where diag holds the per-boundary slot offsets
    and overlap agreement ratios.
    """
    P, Q = loops.rationalize_sps(sps)
    sps_nom = P / Q
    n = len(x)
    span_syms = int(np.ceil(n / sps_nom / nshards))
    L = int(np.ceil(sps_nom)) + 2 * W + loops.NTAPS
    # span s processes stream symbols [s*span_syms - overlap,
    # (s+1)*span_syms): the leading ``overlap`` symbols are cold-acquisition
    # warm-up (discarded), so every KEPT symbol comes from a converged loop
    span_in = int(np.ceil((span_syms + overlap_syms) * sps_nom)) + L

    starts = [int(np.floor(max(s * span_syms - overlap_syms, 0)
                           * sps_nom)) for s in range(nshards)]
    xp = np.concatenate([np.zeros(W, np.float32),
                         np.asarray(x, np.float32),
                         np.zeros(span_in, np.float32)])
    spans = np.stack([xp[st: st + span_in] for st in starts])

    if mesh is None:
        owners = [resolve(device)] * nshards
    else:
        nt = mesh.shape["time"]
        if nshards % nt:
            raise ValueError(f"{nshards} spans do not split over the "
                             f"{nt} entries of the mesh's time axis")
        ax = mesh.axis("time")
        owners = [mesh.devices[tuple(s * nt // nshards if a == ax else 0
                                     for a in range(mesh.devices.ndim))]
                  for s in range(nshards)]
    batches = {}
    for s, dev in enumerate(owners):
        batches.setdefault(dev, []).append(s)
    ys = None
    for dev, idx in batches.items():
        y = _span_symbols(torch.from_numpy(spans[idx]).to(dev), sps,
                          gain_omega, gain_mu, omega_relative_limit, W)
        y = y.cpu().numpy()
        if ys is None:
            ys = np.empty((nshards, y.shape[1]), y.dtype)
        ys[idx] = y

    # splice: span 0 starts at stream symbol 0 with no warm-up (the same
    # preload as the continuous loop); span s >= 1 keeps local [overlap +
    # d_s, overlap + d_s + span_syms), with d_s recovered by correlating
    # its post-settle warm-up against span s-1's KEPT symbols at the same
    # stream positions
    settle = max(overlap_syms // 2, 64)
    out = [ys[0][:span_syms]]
    diag = {"offsets": [], "agreement": []}
    for s in range(1, nshards):
        cur = ys[s]
        prev = ys[s - 1]
        # stream window [s*span_syms - overlap + settle, s*span_syms): span s
        # local [settle, overlap); span s-1 local (plus its own warm-up
        # offset for s-1 >= 1)
        poff = 0 if s == 1 else overlap_syms
        a = np.sign(prev[poff + span_syms - overlap_syms + settle:
                         poff + span_syms - 8])
        best_off, best_score = 0, -1.0
        for off in range(-4, 5):
            lo = settle + off
            b = np.sign(cur[lo: lo + len(a)]) if lo >= 0 else None
            if b is None or len(b) != len(a):
                continue
            score = float((a == b).mean())
            if score > best_score:
                best_off, best_score = off, score
        diag["offsets"].append(best_off)
        diag["agreement"].append(best_score)
        keep = cur[overlap_syms + best_off:
                   overlap_syms + best_off + span_syms]
        out.append(keep)
    symbols = np.concatenate(out)
    total = int(np.floor((n - L) / sps_nom))
    return symbols[:total], diag
