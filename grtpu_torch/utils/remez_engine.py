"""Self-contained Parks-McClellan (Remez exchange) equiripple FIR design.

Analog of gr_remez (gnuradio-core/src/lib/general/gr_remez.cc — the
classic McClellan/Parks/Rabiner program; API per gr_remez.h:42-58: bands
as edge pairs, desired amplitude PER BAND EDGE linearly interpolated
across each band, one error weight per band, filter types bandpass /
hilbert / differentiator).

This is a clean NumPy re-derivation of the textbook algorithm, not a
translation: the Chebyshev approximation runs on x = cos(2*pi*f) with
barycentric Lagrange interpolation over the extremal set (log-domain
barycentric weights for stability at high orders), per-band local-extrema
selection with alternation enforcement, and tap recovery by Hermitian
IDFT of the converged amplitude response.  Design-time code — runs on the
host in float64.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class RemezError(RuntimeError):
    pass


# ---------------------------------------------------------------- helpers
def _filter_class(numtaps: int, ftype: str):
    """-> (antisymmetric, Q(f) factor fn, n_cosine_basis).

    Linear-phase classes: I (sym odd), II (sym even), III (anti odd),
    IV (anti even).  The approximation always targets a pure cosine
    polynomial P(x); the class's Q(f) factor divides the desired response.
    """
    anti = ftype in ("hilbert", "differentiator")
    odd = numtaps % 2 == 1
    if not anti:
        if odd:   # type I
            return False, (lambda f: np.ones_like(f)), (numtaps + 1) // 2
        return False, (lambda f: np.cos(np.pi * f)), numtaps // 2
    if odd:       # type III
        return True, (lambda f: np.sin(2 * np.pi * f)), (numtaps - 1) // 2
    return True, (lambda f: np.sin(np.pi * f)), numtaps // 2


def _build_grid(bands: np.ndarray, des_edges: np.ndarray,
                weights: np.ndarray, r: int, grid_density: int,
                ftype: str, qfn, clamp0: bool, clamp_half: bool):
    """Dense frequency grid with per-point desired/weight.

    Desired is linearly interpolated between the band's two edge values
    (gr_remez.cc:123); differentiator scales desired by f and weight by
    1/f on bands with non-tiny desired (the classic EFF/WATE rules).
    Band edges are nudged off the Q(f) zeros the class divides by.
    """
    delf = 0.5 / (grid_density * r)
    gf, gd, gw, seg = [], [], [], []
    for b in range(len(bands) // 2):
        f1, f2 = bands[2 * b], bands[2 * b + 1]
        if clamp0 and f1 < delf:
            f1 = delf
        if clamp_half and f2 > 0.5 - delf:
            f2 = 0.5 - delf
        npts = max(int(round((f2 - f1) / delf)) + 1, 5)
        f = np.linspace(f1, f2, npts)
        d1, d2 = des_edges[2 * b], des_edges[2 * b + 1]
        d = d1 + (d2 - d1) * (f - f1) / max(f2 - f1, 1e-30)
        w = np.full(npts, weights[b], np.float64)
        if ftype == "differentiator":
            big = d > 1e-4
            d = np.where(big, d * f, d)
            w = np.where(big, w / np.maximum(f, delf), w)
        gf.append(f)
        gd.append(d)
        gw.append(w)
        seg.append(npts)
    f = np.concatenate(gf)
    q = qfn(f)
    # approximation runs on P = A/Q with weight W*Q
    return (f, np.concatenate(gd) / q, np.concatenate(gw) * q,
            np.cumsum([0] + seg))


def _barycentric_weights(x: np.ndarray) -> np.ndarray:
    """gamma_k = 1/prod_{j!=k}(x_k - x_j), computed in the log domain and
    rescaled by the mean exponent (delta and P are ratios in gamma, so a
    common scale factor cancels)."""
    dx = x[:, None] - x[None, :]
    np.fill_diagonal(dx, 1.0)
    logs = -np.sum(np.log(np.abs(dx)), axis=1)
    signs = np.prod(np.sign(dx), axis=1)
    return signs * np.exp(logs - logs.mean())


def _eval_P(xq, xe, gamma, ce):
    """Barycentric evaluation of the degree-r polynomial through
    (xe, ce) at query points xq; exact passthrough where xq hits xe."""
    diff = xq[:, None] - xe[None, :]
    hit = np.isclose(diff, 0.0, atol=1e-14)
    safe = np.where(hit, 1.0, diff)
    k = gamma[None, :] / safe
    num = (k * ce[None, :]).sum(axis=1)
    den = k.sum(axis=1)
    out = num / den
    any_hit = hit.any(axis=1)
    if any_hit.any():
        out[any_hit] = ce[hit.argmax(axis=1)[any_hit]]
    return out


def _select_extrema(E: np.ndarray, seg: np.ndarray, r: int) -> np.ndarray:
    """Pick r+1 alternating extremal indices of the weighted error.

    Candidates are per-band-segment local maxima of |E| plus segment
    endpoints; same-sign runs collapse to their largest member; surplus
    points drop from whichever end has the smaller error."""
    cands = []
    for s in range(len(seg) - 1):
        lo, hi = seg[s], seg[s + 1]
        e = E[lo:hi]
        if hi - lo <= 2:
            cands.extend(range(lo, hi))
            continue
        a = np.abs(e)
        local = np.nonzero((a[1:-1] >= a[:-2]) & (a[1:-1] >= a[2:]))[0] + 1
        idx = {0, hi - lo - 1} | set(local.tolist())
        cands.extend(lo + i for i in sorted(idx))
    keep: List[int] = []
    for i in cands:
        if keep and np.sign(E[i]) == np.sign(E[keep[-1]]):
            if abs(E[i]) > abs(E[keep[-1]]):
                keep[-1] = i
        else:
            keep.append(i)
    while len(keep) > r + 1:
        if abs(E[keep[0]]) < abs(E[keep[-1]]):
            keep.pop(0)
        else:
            keep.pop()
    if len(keep) < r + 1:
        raise RemezError(
            f"only {len(keep)} alternations found for {r + 1} needed — "
            "grid too coarse or spec infeasible")
    return np.asarray(keep)


# ------------------------------------------------------------------- core
def design(numtaps: int, bands: Sequence[float], des_edges: Sequence[float],
           weights: Optional[Sequence[float]] = None,
           ftype: str = "bandpass", grid_density: int = 16,
           maxiter: int = 40) -> np.ndarray:
    """Equiripple design.  bands: normalized edge pairs in [0, 0.5];
    des_edges: desired amplitude per band edge; weights: per band."""
    bands = np.asarray(bands, np.float64)
    des_edges = np.asarray(des_edges, np.float64)
    nb = len(bands) // 2
    if weights is None:
        weights = np.ones(nb)
    weights = np.asarray(weights, np.float64)
    if len(des_edges) == nb:      # scipy-style: one desired per band
        des_edges = np.repeat(des_edges, 2)
    if ftype not in ("bandpass", "hilbert", "differentiator"):
        raise ValueError(f"unknown filter type {ftype!r}")
    anti, qfn, r = _filter_class(numtaps, ftype)
    even = numtaps % 2 == 0
    if r < 1:
        raise ValueError("numtaps too small for this filter class")
    clamp0 = anti                                  # III/IV: Q(0) = 0
    clamp_half = (even and not anti) or (anti and not even)  # II, III
    f, D, W, seg = _build_grid(bands, des_edges, weights, r, grid_density,
                               ftype, qfn, clamp0, clamp_half)
    x = np.cos(2 * np.pi * f)

    # initial extremal guess: evenly spread over the grid
    ext = np.unique(np.round(np.linspace(0, len(f) - 1, r + 1)).astype(int))
    if len(ext) < r + 1:
        raise RemezError("grid too small; raise grid_density")

    last_delta = None
    for _ in range(maxiter):
        xe = x[ext]
        gamma = _barycentric_weights(xe)
        signs = (-1.0) ** np.arange(r + 1)
        delta = ((gamma * D[ext]).sum()
                 / (gamma * signs / W[ext]).sum())
        ce = D[ext] - signs * delta / W[ext]
        P = _eval_P(x, xe, gamma, ce)
        E = W * (P - D)
        new_ext = _select_extrema(E, seg, r)
        if np.array_equal(new_ext, ext):
            break
        if last_delta is not None and abs(abs(delta) - abs(last_delta)) \
                <= 1e-12 * max(abs(delta), 1e-12):
            ext = new_ext
            break
        ext, last_delta = new_ext, delta

    # tap recovery: Hermitian IDFT of the converged amplitude response
    # A(f) = Q(f) P(cos 2 pi f), evaluated at the TRUE bin frequency:
    # P(cos 2 pi f) is automatically symmetric about f=0.5, and Q's own
    # parity there (cos pi f odd, sin pi f even, sin 2 pi f odd) is
    # exactly the extension each linear-phase class requires for
    # H(f) = (-i)^anti A(f) e^{-i 2 pi f M} to be Hermitian.
    n = numtaps
    M = (n - 1) / 2.0
    fj = np.arange(n) / n
    xe = x[ext]
    gamma = _barycentric_weights(xe)
    signs = (-1.0) ** np.arange(r + 1)
    delta = (gamma * D[ext]).sum() / (gamma * signs / W[ext]).sum()
    ce = D[ext] - signs * delta / W[ext]
    A = _eval_P(np.cos(2 * np.pi * fj), xe, gamma, ce) * qfn(fj)
    H = A * np.exp(-2j * np.pi * fj * M)
    if anti:
        # +i matches the classic program's sign convention (and scipy's)
        H = H * 1j
    h = np.fft.ifft(H).real
    return h.astype(np.float64)


def pm_remez(order: int, bands: Sequence[float], ampl: Sequence[float],
             error_weight: Optional[Sequence[float]] = None,
             filter_type: str = "bandpass",
             grid_density: int = 16) -> np.ndarray:
    """gr_remez API (gr_remez.h:42-58): order = numtaps-1, band edges
    normalized to Fs=1 (so passband edges in [0, 1) meaning [0, Fs)),
    desired amplitude per band edge, one weight per band."""
    bands = np.asarray(bands, np.float64) / 2.0   # gr normalizes to Fs=1
    return design(order + 1, bands, ampl, error_weight, filter_type,
                  grid_density)
