"""Hopper FIR kernels behind the public API of ``grtpu.ops.pallas_fir``.

Port of ``grtpu.ops.pallas_fir``: the same public functions and signatures
minus ``interpret`` — ``fir_cascade``, ``fir_long``, ``batch_fir_long``,
``fir_decim``, ``fir_decim_c``, ``fir_decim_cc`` and ``_phase_split_taps`` —
over the CUDA C++ kernels in ``grtpu_torch/csrc``:

* ``fir_tile_fwd``     — one FIR per batch row (row i uses tap set i % G),
  with a decimation stride and an optional zero lead, f32 or bf16 input,
  float32 FMAs on the CUDA cores, the taps streamed in blocks.  It serves
  decimation 1 in f32 and outside the tensor-core route's tap range, and
  decimating calls whose window is too large for the two kernels below.
* ``fir_toeplitz_fwd`` — the same single-stage FIR at decimation 1 in bf16
  and bf16x3, on the tensor cores (``wgmma``): rows of the stream against
  the Toeplitz matrix of the taps.
* ``fir_decim_fwd``    — decimation > 1 on the CUDA cores (f32, and bf16 /
  bf16x3 below ``_dm_min_taps`` taps): a ring of ``cp.async`` stages feeds a
  phase-major window, the phases split over the threads of a block.
* ``fir_decim_mma_fwd`` — decimation > 1 in bf16 and bf16x3 on the tensor
  cores (``mma.sync``): windows of the stream, 8 outputs apart, against the
  strided Toeplitz matrix of the taps, behind the same ring.

  Both decimating kernels and ``fir_tile_fwd`` also take a complex64
  stream in one launch (``cplx`` 1, ccf: real taps; 2, ccc: complex64
  taps): the stream is read interleaved and the output written
  interleaved, the re / im split made in shared memory.  That is
  ``fir_decim_c`` and ``fir_decim_cc`` on the card at every decimation
  (at decimation 1 ``fir_decim_mma_fwd`` in the bf16 modes,
  ``fir_decim_fwd`` or ``fir_tile_fwd`` in f32), and ``fir_tile_fwd`` for
  windows too large for the decimating kernels.  Only :func:`_route`'s
  "planes" shapes (the bf16 modes' long filters at decimation 1, which
  run faster so, and decimations no complex plan fits) run the real FIR
  over the stacked re / im planes.  Every route gives channel c tap set
  c % G of (G, K) taps for both its planes.
* ``fir_cascade_fwd``  — S chained FIRs with the same taps from zero
  history, the stages resident in shared memory, float32 FMAs (f32).
* ``fir_cascade_mma_fwd`` — the same cascade in bf16 and bf16x3, each stage
  the tensor-core product of ``fir_toeplitz_fwd``.

:func:`_route` says which of the single-stage kernels a call takes, as a
pure function of (precision, decim, K, B, nout); :func:`_launch_plan` turns
a call's shape into the kernel's launch parameters once and keeps them.

Every public function holds the contract ``y[i] = sum_k taps[k] *
x[i*d + K-1-k]`` (x carrying K-1 samples of history, or zero history for
fir_cascade); the TPU kernel's halo and orientation bookkeeping
(``_pad_taps``, ``_tap_group``, the 8-sublane rounding) has no counterpart.

Dispatch is by the tensor's device: a CPU tensor runs the kernel's plain
PyTorch twin (:func:`fir_tile_ref`, :func:`fir_cascade_ref`; a complex
stream as its two planes); a CUDA tensor launches the kernel, building it
at first use, or raises.  :func:`fir_toeplitz_ref`,
:func:`fir_decim_mma_ref` and :func:`fir_decim_cplx_ref` are the plain
forms of the tensor-core routes' and the complex modes' own arithmetic.
``launches`` counts the kernel launches, one per launch under the name of
the entry that was called, for callers that must show a path went through
the kernels.  A launch made while a CUDA graph is captured launches
nothing: inside :func:`recording_launches` it goes to the record instead,
and each replay of the graph adds the record to ``launches``
(:func:`add_launches`).

``tile_rows`` is accepted for grtpu signature compatibility; the Hopper
kernels size their tiles from shared memory and the batch instead.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from grtpu_torch.ops.fir import (PRECISIONS, fir_filter, pad_last,
                                 real_matmul)

LANE = 128

# Kernel launch counts, by the name of the C entry that was called: the FIR
# kernels here, the two recursion kernels of grtpu_torch.ops.cuda_trellis and
# the first-order IIR of grtpu_torch.ops.cuda_iir, so that one record of a
# CUDA-graph capture holds them all.  MODE_COUNTS name a mode of a launch
# that its C entry's count already holds: ``fir_decim_cc`` counts the calls
# of :func:`fir_decim_cc` that ran as one launch in the complex-taps mode.
FIR_KERNELS = ("fir_tile_fwd", "fir_toeplitz_fwd", "fir_decim_fwd",
               "fir_decim_mma_fwd", "fir_cascade_fwd", "fir_cascade_mma_fwd")
MODE_COUNTS = ("fir_decim_cc",)
launches = dict.fromkeys(FIR_KERNELS + ("viterbi_fwd", "dfe_feedback_fwd",
                                        "iir1_fwd") + MODE_COUNTS, 0)

# Open records of CUDA-graph captures (recording_launches), innermost last.
_recording = []

_PRECISION_CODE = {"f32": 0, "bf16": 1, "bf16x3": 2}
# The decimating kernels' stream modes: real, complex stream against real
# taps, complex stream against complex taps.
REAL, CCF, CCC = 0, 1, 2
_THREADS = 256           # fir_tile_fwd: threads a block, 8 outputs each
_KBLK = 2048             # fir_tile_fwd: taps staged in shared memory per pass
_MAX_TILE_SPAN = 4096    # input samples a fir_tile_fwd window spans, at most
_SMEM_OPTIN = 232448     # bytes of shared memory a Hopper block may opt into
_TZ_PASS_ROWS = 128      # output rows of 128 a tensor-core block computes per pass
_H100_SMS = 132          # blocks are sized for this many SMs off the card
_DC_THREADS = 128        # threads a block of the decimating kernels
_DC_STAGES = 3           # stages of their load ring
# Below this many taps the tensor-core route stops winning: its work grows as
# (K + 127) / K.  16 x 2^20 on an H100 (700 W), tensor / FMA ms: K 32 bf16
# 0.082 / 0.076, bf16x3 0.116 / 0.135; K 64 bf16 0.078 / 0.099, bf16x3
# 0.120 / 0.206; K 128 bf16 0.078 / 0.148, bf16x3 0.117 / 0.351
# (chip_smoke.py prints these as "routes ...").
_TZ_MIN_TAPS = 64
# Above these many taps the tensor-core route's tap words and its two-stage
# ring of 128 + ceil((K + 127) / 128) - 1 stream rows no longer fit a block's
# shared memory (_toeplitz_smem), and the call takes the FMA route, about 15x
# slower at these lengths; the cascade's stages have the same limit, and
# need nstages * (K - 1) < 128 * 127 besides (_cascade_mma_tile).
_TZ_MAX_TAPS = {"bf16": 20481, "bf16x3": 6145}
# From how many taps a decimating bf16 or bf16x3 call takes the tensor cores,
# by decimation (its work grows as (8 * decim + K - 1) / K, and a block's
# tile shrinks with the decimation).  64 x 2^15 outputs on an H100 (700 W),
# tensor / FMA ms from a CUDA graph (``python -m grtpu_torch.ops.sweep_plans``
# prints these as "routes ..."):
#   decimation 2   bf16   K 64 0.0236 / 0.0206   K 128 0.0252 / 0.0267
#                  bf16x3 K 32 0.0258 / 0.0250   K 64  0.0267 / 0.0329
#   decimation 3   bf16   K 32 0.0241 / 0.0232   K 64  0.0246 / 0.0261
#                  bf16x3 K 16 0.0256 / 0.0279
#   decimation 4   bf16   K 32 0.0264 / 0.0242   K 64  0.0261 / 0.0271
#                  bf16x3 K 16 0.0231 / 0.0346
#   decimation 8   bf16   K 16 0.0316 / 0.0387   bf16x3 K 16 0.0357 / 0.0618
#   decimation 16  bf16   K 16 0.0649 / 0.0896   bf16x3 K 16 0.0952 / 0.1814
# Nothing was timed under 16 taps, nor at decimations 5 to 7 (taken as 4).
_DM_MIN_TAPS = {"bf16": {2: 128, 3: 64, 4: 64, 5: 64, 6: 64, 7: 64},
                "bf16x3": {2: 64}}
_DM_MIN_TAPS_ELSE = 16
# The complex modes take the tensor cores from 16 taps at every decimation:
# the same sweep on a complex64 stream, tensor / FMA ms, ccf and ccc,
#   decimation 2   bf16   K 16 0.0242 / 0.0257   0.0259 / 0.0363
#                  bf16x3 K 16 0.0254 / 0.0357   0.0316 / 0.0586
#   decimation 3-16, bf16 and bf16x3, 16 to 256 taps: tensor 1.05-7.0x ahead
# (H100, 700 W; twice the FLOP a byte of the real stream moves the
# crossovers below 16 taps, where nothing was timed).
#
# A complex stream at decimation 1 (``python -m grtpu_torch.ops.sweep_plans
# --decim1`` prints these; H100 at 700 W, from a CUDA graph, 64 x 2^15
# outputs, ms) takes the tensor cores from 16 taps too (fir_decim_mma_fwd /
# fir_decim_fwd, ccf: bf16 K16 0.0120 / 0.0153, bf16x3 0.0131 / 0.0221;
# ccc bf16 0.0125 / 0.0203).  Its FMA route is fir_decim_fwd (one phase
# group) below _D1_TILE_TAPS taps and fir_tile_fwd's complex mode from them
# (fir_decim_fwd / fir_tile_fwd, f32: ccf K155 0.0413 / 0.0420, K512
# 0.1106 / 0.1064, K1024 0.2166 / 0.2015, K2048 0.4497 / 0.3962; ccc K155
# 0.0708 / 0.0748, K1024 0.3788 / 0.3752, K2048 0.9320 / 0.7650, but K4097
# 1.8479 / 2.2392; on the WBFM bank, 64 x 2^18 K155, ccf 0.2929 / 0.3114,
# ccc 0.5327 / 0.5838).
_D1_TILE_TAPS = 1024
# From these taps (to _TZ_MAX_TAPS) its bf16 modes run faster as the real
# FIR over the stacked planes on fir_toeplitz_fwd (wgmma, the Toeplitz
# matrix in registers), where the decimating route's block, whose window
# grows with the taps, falls to three, then one or two blocks an SM
# (fir_decim_mma_fwd / planes: ccf bf16x3 K512 0.0649 / 0.0657, K1024
# 0.1297 / 0.0829, K4097 0.6358 / 0.1873; ccc bf16x3 K1024 0.1584 /
# 0.1633, K2048 0.5336 / 0.2328; bf16 alike).  Those shapes take the
# "planes" route on the card too.
_D1_PLANES_TAPS = {CCF: 1024, CCC: 2048}
# Tiles a block of a decimating kernel walks at decimation 1, at most: on
# the WBFM bank as a complex stream (ms), fir_decim_mma_fwd ccf bf16x3 at
# four tiles a block 0.1745 at 2, 0.1737 at 4, 0.1828 at 13 (the waves
# rule's pick), 0.1859 at 16; fir_decim_fwd ccf f32 0.2809 at 2, 0.3087 at
# 13; ccc f32 0.5169 at 2, 0.5438 at 16.
_D1_TILES_A_BLOCK = 2


def _dm_min_taps(precision: str, decim: int, cplx: int = REAL) -> int:
    """Taps from which ``precision`` at ``decim`` takes the tensor cores
    (``cplx``: the stream mode)."""
    if cplx:
        return _DM_MIN_TAPS_ELSE
    return _DM_MIN_TAPS[precision].get(decim, _DM_MIN_TAPS_ELSE)


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"expected one of {PRECISIONS}")


def _tapsets(taps, device) -> torch.Tensor:
    """Taps (K,) or tap sets (G, K), numpy or tensor -> (G, K) float32."""
    t = taps if isinstance(taps, torch.Tensor) else torch.as_tensor(
        np.asarray(taps, np.float32))
    t = t.to(device=device, dtype=torch.float32)
    return (t[None] if t.ndim == 1 else t).contiguous()


# ------------------------------------------------------------- plain twins
def fir_tile_ref(x: torch.Tensor, tapsets: torch.Tensor, decim: int,
                 lead: int, nout: int, precision: str) -> torch.Tensor:
    """Plain PyTorch twin of ``fir_tile_fwd``:
    ``y[b, i] = sum_k T[b % G, k] * x[b, i*decim + K-1-k - lead]`` with x
    zero outside its extent, as a Toeplitz block matmul in float32 (the bf16
    modes round the operands to bf16 first)."""
    g, k = tapsets.shape
    need = nout * decim + k - 1
    xp = pad_last(x.to(torch.float32), lead, 0)
    xp = pad_last(xp, 0, max(0, need - xp.shape[-1]))[:, :need]
    y = torch.empty((x.shape[0], nout), dtype=torch.float32, device=x.device)
    for j in range(g):
        y[j::g] = fir_filter(xp[j::g], tapsets[j], decim, precision)
    return y


def fir_cascade_ref(x: torch.Tensor, taps: torch.Tensor, nstages: int,
                    precision: str) -> torch.Tensor:
    """Plain PyTorch twin of ``fir_cascade_fwd``: ``nstages`` chained FIRs
    from zero history, each a Toeplitz block matmul in float32 whose input
    is re-rounded in the bf16 modes."""
    y = x.to(torch.float32)
    k = taps.shape[-1]
    for _ in range(nstages):
        y = fir_filter(pad_last(y, k - 1, 0), taps, 1, precision)
    return y


# ------------------------------------------- the tensor-core route, plain
def toeplitz_taps(taps: torch.Tensor) -> torch.Tensor:
    """The Toeplitz matrix of one tap set for the tensor-core route:
    ``T[j, c] = taps[K-1 - (j - c)]`` where that index is a tap, else 0,
    shape (nh*128, 128) with nh = ceil((K + 127) / 128)."""
    k = taps.shape[-1]
    nh = -(-(k + LANE - 1) // LANE)
    hs = taps.new_zeros((nh + 1) * LANE)      # hs[i] = reversed taps[i - 128]
    hs[LANE:LANE + k] = taps.flip(-1)
    j = torch.arange(nh * LANE, device=taps.device)[:, None]
    c = torch.arange(LANE, device=taps.device)[None, :]
    return hs[LANE + j - c]


def fir_toeplitz_ref(x: torch.Tensor, tapsets: torch.Tensor, lead: int,
                     nout: int, precision: str) -> torch.Tensor:
    """Plain PyTorch form of the tensor-core route's own arithmetic (same
    contract as :func:`fir_tile_ref` at decim 1): the stream behind ``lead``
    zeros is staged as rows of 128 samples, and output row r is
    ``sum_jb rows[r + jb] @ T[jb*128:(jb+1)*128]`` over the Toeplitz matrix
    of the taps, operands rounded to bf16 (bf16x3: hi and lo words, products
    hi*hi + hi*lo + lo*hi) and summed in float32."""
    b, total = x.shape
    g, k = tapsets.shape
    nh, seg_rows, nseg, lrows = _toeplitz_plan(b, nout, k)
    xp = x.new_zeros((b, lrows * LANE), dtype=torch.float32)
    keep = min(total, lrows * LANE - lead)
    xp[:, lead:lead + keep] = x[:, :keep]
    rows = xp.view(b, lrows, LANE)
    r = nseg * seg_rows
    y = torch.zeros((b, r, LANE), dtype=torch.float32, device=x.device)
    for j in range(g):
        t = toeplitz_taps(tapsets[j])
        for jb in range(nh):
            y[j::g] += real_matmul(rows[j::g, jb:jb + r],
                                   t[jb * LANE:(jb + 1) * LANE], precision)
    return y.reshape(b, r * LANE)[:, :nout]


def strided_toeplitz_taps(taps: torch.Tensor, decim: int) -> torch.Tensor:
    """The strided Toeplitz matrix of one tap set for the decimating
    tensor-core route: ``T[c, o] = taps[K-1 - (c - o*decim)]`` where that
    index is a tap, else 0, shape (16*ks, 8) with ks = ceil((8*decim + K-1)
    / 16) k-steps of 16 window positions."""
    k = taps.shape[-1]
    ks = -(-(8 * decim + k - 1) // 16)
    c = torch.arange(16 * ks, device=taps.device)[:, None]
    o = torch.arange(8, device=taps.device)[None, :]
    m = c - o * decim
    valid = (m >= 0) & (m < k)
    return torch.where(valid, taps.flip(-1)[m.clamp(0, k - 1)],
                       taps.new_zeros(()))


def fir_decim_mma_ref(x: torch.Tensor, tapsets: torch.Tensor, decim: int,
                      lead: int, nout: int, precision: str) -> torch.Tensor:
    """Plain PyTorch form of the decimating tensor-core route's own
    arithmetic (same contract as :func:`fir_tile_ref`): segment s of the
    stream behind ``lead`` zeros is the window of 16*ks samples at sample
    ``s*8*decim``, and its 8 outputs are ``sum_kk seg[16*kk:16*kk+16] @
    T[16*kk:16*kk+16]`` over the strided Toeplitz matrix of the taps,
    operands rounded to bf16 (bf16x3: hi and lo words, products hi*hi +
    hi*lo + lo*hi) and summed in float32, k-step by k-step."""
    b, total = x.shape
    g, k = tapsets.shape
    ks = -(-(8 * decim + k - 1) // 16)
    nseg = max(1, -(-nout // 8))
    need = (nseg - 1) * 8 * decim + 16 * ks
    xp = x.new_zeros((b, need), dtype=torch.float32)
    keep = max(0, min(total, need - lead))
    xp[:, lead:lead + keep] = x[:, :keep]
    segs = xp.unfold(-1, 16 * ks, 8 * decim)
    y = torch.zeros((b, nseg, 8), dtype=torch.float32, device=x.device)
    for j in range(g):
        t = strided_toeplitz_taps(tapsets[j], decim)
        for kk in range(ks):
            y[j::g] += real_matmul(segs[j::g, :, 16 * kk:16 * kk + 16],
                                   t[16 * kk:16 * kk + 16], precision)
    return y.reshape(b, nseg * 8)[:, :nout]


def fir_decim_cplx_ref(x: torch.Tensor, taps: torch.Tensor, decim: int,
                       lead: int, nout: int, precision: str,
                       cplx: int) -> torch.Tensor:
    """Plain PyTorch form of the decimating kernels' complex modes (the
    contract of :func:`fir_tile_ref` on a complex64 stream ``x`` (B,
    total), row b on tap set b % G of ``taps`` (K,) or (G, K)): float32
    (``cplx`` 1, ccf) or complex64 (2, ccc).  Each (stream plane, tap
    plane) pair is one real sum with the mode's split-word products; ccf
    returns re.t + j im.t, ccc (re.tr - im.ti) + j (re.ti + im.tr)."""
    tapsets = taps if taps.ndim == 2 else taps[None]
    re, im = x.real, x.imag

    def s(plane, t):
        return fir_tile_ref(plane, t, decim, lead, nout, precision)

    if cplx == CCF:
        return torch.complex(s(re, tapsets), s(im, tapsets))
    tr, ti = tapsets.real, tapsets.imag
    return torch.complex(s(re, tr) - s(im, ti), s(re, ti) + s(im, tr))


# ------------------------------------- shared-memory sizes, as fir_*.cu has them
def _skew(col: int) -> int:
    return col + ((col >> 5) << 2)


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def _npl(precision: str) -> int:
    return 2 if precision == "bf16x3" else 1


def _toeplitz_smem(precision: str, k: int) -> int:
    """Bytes of shared memory one block of the decimation-1 tensor-core
    routes uses for ``k`` taps (fir_tile.cu's ``toeplitz_smem``): the tap
    words of each plane in two parity copies, rounded up to 1024, then two
    stages of swizzled rows, 256 bytes a row and plane."""
    npl = _npl(precision)
    nh = -(-(k + LANE - 1) // LANE)
    tap_words = LANE // 2 * (nh + 1) + 16
    tap_bytes = -(-npl * 2 * 4 * tap_words // 1024) * 1024
    rows = -(-(_TZ_PASS_ROWS + nh - 1) // 8) * 8
    return tap_bytes + 2 * npl * 2 * rows * LANE


def _tile_smem(precision: str, threads: int, decim: int, kblk: int,
               cplx: int = REAL) -> int:
    """fir_tile.cu's ``tile_smem``: per precision plane, ``decim`` rows of
    taps a tap plane and of the skewed window of threads * 8 outputs a
    stream plane."""
    nc, nt = _planes(cplx)
    q8 = _round(-(-kblk // decim), 8)
    row = _round(_skew(threads * 8 + q8 + 8), 4)
    return 4 * _npl(precision) * decim * (nt * q8 + nc * row)


def _cascade_smem(precision: str, k: int, nstages: int, tile: int) -> int:
    """fir_tile.cu's ``cascade_smem``: per plane, the taps and two skewed
    buffers of the tile, its lookback and the slack."""
    cols = _round(tile + nstages * (k - 1) + 24, 8)
    cap = _round(_skew(cols), 4) + 4
    return 4 * _npl(precision) * (_round(k, 8) + 2 * cap)


def _ring_stage_bytes(wl: int, es: int) -> int:
    per = 16 // es
    return (wl + 3 * per - 1) // per * 16


def _planes(cplx: int):
    """(stream planes, tap planes) of a complex mode: real 1, 1; ccf 2, 1;
    ccc 2, 2.  The kernels keep one sum a pair."""
    return (2 if cplx else 1), (2 if cplx == CCC else 1)


def _elem_bytes(cplx: int) -> int:
    """Bytes of a float32 stream's element (a complex64 one in the complex
    modes)."""
    return 8 if cplx else 4


def _with_ring(ring_bytes: int, rest: int) -> int:
    """fir_decim.cu's ``decim_fits``: a block's bytes with its ring of
    three stages where that fits shared memory, else without (the block
    then takes its windows out of device memory)."""
    return (_DC_STAGES * ring_bytes + rest
            if _DC_STAGES * ring_bytes + rest <= _SMEM_OPTIN else rest)


def _decim_smem(precision: str, es: int, k: int, decim: int, kp: int,
                cplx: int = REAL) -> int:
    """fir_decim.cu's ``decim_smem`` as a launch chooses it: the ring's
    stages of raw samples (es bytes each) where they fit, per precision
    plane ``decim`` rows of taps (a row a tap plane) and of the skewed
    window of 1024 / kp outputs (a window a stream plane), whose space the
    1024 partial sums a (stream plane, tap plane) pair take once it is
    read."""
    nc, nt = _planes(cplx)
    to = _DC_THREADS // kp * 8
    q8 = _round(-(-k // decim), 8)
    row = _round(_skew(to + q8 + 8), 4)
    if decim in (2, 4, 8):
        while row % (64 // decim) != 32 // decim:
            row += 4
    return _with_ring(_ring_stage_bytes((to - 1) * decim + k, es),
                      4 * (_npl(precision) * decim * nt * q8
                           + max(_npl(precision) * decim * nc * row,
                                 nc * nt * _DC_THREADS * 8)))


def _decim_mma_smem(precision: str, es: int, k: int, decim: int,
                    mtb: int, cplx: int = REAL) -> int:
    """fir_decim.cu's ``decim_mma_smem`` as a launch chooses it: the ring's
    stages where they fit, per precision plane the padded bf16 window of
    ``mtb`` tiles (a window a stream plane), whose space the 512 partial
    sums a (stream plane, tap plane) pair take once it is read, and two
    parity copies of the tap words (a tap plane each)."""
    nc, nt = _planes(cplx)
    ks = -(-(8 * decim + k - 1) // 16)
    wb = (16 * mtb - 1) * 8 * decim + 16 * ks
    plane = _round(wb + ((wb // (8 * decim) + 1) * 8
                         if decim in (2, 4, 8) else 0), 8)
    off = (7 * decim + 1) & ~1
    words = _round((off + 16 * ks + 2) // 2 + 1, 32) + 16
    return _with_ring(_ring_stage_bytes(wb, es),
                      max(_npl(precision) * 2 * nc * plane,
                          4 * nc * nt * _DC_THREADS * 4)
                      + _npl(precision) * 8 * nt * words)


# ------------------------------------------------------ routes and plans
def _blocks_per_row(b: int, tiles: int, sms: int, smem: int) -> int:
    """Tiles of one row a block of a decimating kernel walks, at most 16.  A
    block's phases (load, take out, compute) are serial, so the card
    overlaps them across the blocks an SM holds (as many as fit its shared
    memory, at most 16 of 128 threads); the grid runs as waves of that many
    blocks, each wave as long as its blocks' tiles plus about one tile of
    start-up (ring, taps).  Take the block size with the least waves x
    (tiles + 1), of equals the longest: a grid smaller than one wave keeps
    one tile a block.  On the WBFM bank (H100, 700 W, from a CUDA graph;
    ``sweep_plans``) this is the fastest measured or within 2% of it for
    every plan the planner takes, where the earlier rule (about three
    fills) lost 5-10%: real bf16x3 13 tiles 0.0414 ms (was 4, 0.0450), f32
    13 tiles 0.0486 (4, 0.0508); as a complex stream ccf 16 tiles 0.0738
    (10, 3.2 waves: 13 tiles ran 0.0816), ccc 16 tiles 0.0989 (best 0.0970
    at 8)."""
    resident = sms * max(1, min(16, 233472 // (smem + 1024)))
    best = None
    for tpb in range(1, 17):
        blocks = -(-tiles // tpb)
        tpb = -(-tiles // blocks)           # the same blocks, evenly filled
        key = (-(-b * blocks // resident) * (tpb + 1), -tpb)
        if best is None or key < best:
            best = key
    return -best[1]


def _d1_tiles(decim: int, tpb: int) -> int:
    """Tiles a block of a decimating kernel walks: at decimation 1 at most
    ``_D1_TILES_A_BLOCK``, where the waves rule of :func:`_blocks_per_row`
    asks for more (its start-up of about a tile is less there)."""
    return min(tpb, _D1_TILES_A_BLOCK) if decim == 1 else tpb


@functools.lru_cache(maxsize=4096)
def _decim_mma_plan(precision: str, decim: int, k: int, b: int, nout: int,
                    sms: int = _H100_SMS, cplx: int = REAL):
    """(mtb, to, tpb) for ``fir_decim_mma_fwd``: ``mtb`` tiles of 128
    outputs a block (each tile's k-steps shared by 4 / mtb warps), ``to``
    outputs a block kept, ``tpb`` such tiles a block walks.  Two tiles a
    block where that still gives every SM two blocks and leaves room for
    four blocks an SM (on the WBFM bank, H100 at 700 W, bf16x3 from a CUDA
    graph: real 0.042-0.048 ms against 0.045-0.055 at four tiles and
    0.045-0.061 at one; as a complex stream, whose two tiles take 80 KB,
    ccf 0.074-0.078 at one tile against 0.087-0.093 at two); a lone chunk
    is cut into blocks of fewer than 128 outputs so that it fills the card.
    ``cplx``: the stream mode, whose planes the block's shared memory
    holds.  At decimation 1 four tiles a block, a warp each, wherever the
    grid still gives every SM two blocks (the WBFM bank as a complex
    stream, ccf bf16x3 from a graph: 0.174-0.186 ms at four tiles, 0.199-
    0.264 at two, 0.258-0.415 at one; 4097 taps 0.589-0.658 / 0.647-0.756
    / 0.762-0.982), and at most ``_D1_TILES_A_BLOCK`` such tiles a block
    (:func:`_d1_tiles`).  None when no block fits shared memory."""
    es = _elem_bytes(cplx)
    options = ((4, 2 * sms),) if decim == 1 else ()
    for mtb, need in options + ((2, 2 * sms), (1, 0)):
        smem = _decim_mma_smem(precision, es, k, decim, mtb, cplx)
        if (b * -(-nout // (128 * mtb)) >= need and smem <= _SMEM_OPTIN
                and (mtb != 2 or 233472 // (smem + 1024) >= 4)):
            break
    else:
        return None
    to = 128 * mtb
    if mtb == 1 and b * -(-nout // 128) < sms:
        to = 8 * max(1, min(16, b * nout // (8 * sms)))
    return mtb, to, _d1_tiles(decim, _blocks_per_row(
        b, -(-nout // to), sms,
        _decim_mma_smem(precision, es, k, decim, mtb, cplx)))


@functools.lru_cache(maxsize=4096)
def _decim_fma_plan(precision: str, decim: int, k: int, b: int, nout: int,
                    sms: int = _H100_SMS, cplx: int = REAL):
    """(kp, tpb) for ``fir_decim_fwd``: ``kp`` groups of threads share the
    phases of a tile of 1024 / kp outputs, ``tpb`` tiles a block walks.
    None when the window does not fit shared memory."""
    es = _elem_bytes(cplx)
    for kp in (4, 2, 1):
        smem = _decim_smem(precision, es, k, decim, kp, cplx)
        if kp <= decim and smem <= _SMEM_OPTIN:
            return kp, _d1_tiles(decim, _blocks_per_row(
                b, -(-nout // (1024 // kp)), sms, smem))
    return None


def _route(precision: str, decim: int, k: int, b: int, nout: int,
           fma: bool = False, cplx: int = REAL) -> str:
    """Which kernel a single-stage call takes: "toeplitz" (a real stream at
    decimation 1, bf16 / bf16x3, ``_TZ_MIN_TAPS`` to ``_TZ_MAX_TAPS``
    taps), "decim_mma" (decimation > 1, bf16 / bf16x3, from
    ``_dm_min_taps`` taps), "decim_fma" (decimation > 1 otherwise), "tile"
    (decimation 1 otherwise, and windows too large for the decimating
    kernels' shared memory) or "empty" (no output).  ``fma`` forces the
    CUDA cores, for timing the routes side by side.  A complex stream
    (``cplx`` CCF or CCC) takes the same kernels in their complex mode, one
    launch, and at decimation 1 follows the record (``sweep_plans
    --decim1``): "decim_mma" in the bf16 modes from ``_dm_min_taps`` taps,
    otherwise "decim_fma" below ``_D1_TILE_TAPS`` taps and "tile" from
    them.  It takes "planes" (the real FIR over its stacked re and im
    planes, on the card too) only where the stacked planes on
    ``fir_toeplitz_fwd`` measured faster (bf16 modes at decimation 1 from
    ``_D1_PLANES_TAPS`` taps) and where no complex plan fits shared
    memory; chosen by shape alone."""
    if b == 0 or nout == 0:
        return "empty"
    tensor = precision != "f32" and not fma
    if decim == 1 and not cplx:
        if tensor and _TZ_MIN_TAPS <= k <= _TZ_MAX_TAPS[precision]:
            return "toeplitz"
        return "tile"
    if (decim == 1 and tensor
            and _D1_PLANES_TAPS[cplx] <= k <= _TZ_MAX_TAPS[precision]):
        return "planes"
    if (tensor and k >= _dm_min_taps(precision, decim, cplx)
            and _decim_mma_plan(precision, decim, k, b, nout,
                                cplx=cplx) is not None):
        return "decim_mma"
    if ((decim > 1 or k < _D1_TILE_TAPS)
            and _decim_fma_plan(precision, decim, k, b, nout,
                                cplx=cplx) is not None):
        return "decim_fma"
    if not cplx or _tile_plan(precision, decim, k, b, nout,
                              cplx=cplx) is not None:
        return "tile"
    return "planes"


class _Plan(NamedTuple):
    """One launch, ready to make: the entry's name, its ctypes function and
    every integer argument between the pointers and the stream."""
    name: str
    fn: object
    args: tuple
    scratch: tuple = ()      # shape of the bf16 scratch fir_toeplitz_fwd takes


def _toeplitz_plan(b: int, nout: int, k: int, sms: int = _H100_SMS):
    """Layout of the decimation-1 tensor-core route for ``b`` rows of
    ``nout`` outputs and ``k`` taps: the stream is read as rows of 128
    samples behind ``lead`` zeros, an output row needs ``nh`` consecutive
    stream rows, and the output rows of a batch row are cut into ``nseg``
    segments of ``seg_rows`` (a multiple of the rows a block computes per
    pass), about two blocks an SM.  Returns (nh, seg_rows, nseg, lrows);
    ``lrows`` is the number of stream rows staged per batch row, zero-filled
    past the data."""
    nh = -(-(k + LANE - 1) // LANE)
    rows = max(1, -(-nout // LANE))
    passes = -(-rows // _TZ_PASS_ROWS)
    segs = max(1, min(2 * sms // max(b, 1), passes))
    seg_rows = -(-passes // segs) * _TZ_PASS_ROWS
    nseg = -(-rows // seg_rows)
    return nh, seg_rows, nseg, nseg * seg_rows + nh - 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _tile_plan(precision: str, decim: int, k: int, b: int, nout: int,
               sms: int = _H100_SMS, cplx: int = REAL):
    """(threads, kblk) for ``fir_tile_fwd`` in stream mode ``cplx``: bound
    the window a tile spans, then shrink tiles until the grid fills the
    card twice over (or the tiles reach one warp).  Where the block does
    not fit shared memory (a complex stream's two windows and ccc's two
    tap rows at high decimations), halve the taps a pass down to 256,
    then the threads down to one warp, then the taps again.  None when
    nothing fits."""
    threads = _THREADS
    while threads > 32 and threads * 8 * decim > _MAX_TILE_SPAN:
        threads //= 2
    while threads > 32 and b * -(-nout // (threads * 8)) < 2 * sms:
        threads //= 2
    kblk = min(k, _KBLK)
    while _tile_smem(precision, threads, decim, kblk, cplx) > _SMEM_OPTIN:
        if kblk > 256:
            kblk = -(-kblk // 2)
        elif threads > 32:
            threads //= 2
        elif kblk > 8:
            kblk = -(-kblk // 2)
        else:
            return None
    return threads, kblk


def _toeplitz_launch(lib, b, total, g, k, lead, nout, precision, sms):
    """The launch of ``fir_toeplitz_fwd`` and its bf16 scratch."""
    nh, seg_rows, nseg, lrows = _toeplitz_plan(b, nout, k, sms)
    assert seg_rows % lib.fir_toeplitz_rows_per_pass() == 0
    return _Plan("fir_toeplitz_fwd", lib.fir_toeplitz_fwd,
                 (b, total, g, k, lead, nout, _PRECISION_CODE[precision],
                  seg_rows, nseg, lrows), (_npl(precision), b, lrows * LANE))


def _decim_launch(name: str, b: int, total: int, g: int, k: int,
                  decim: int, lead: int, nout: int, precision: str, plan,
                  cplx: int = REAL) -> _Plan:
    """The launch of decimating kernel ``name`` ("fir_decim_fwd" or
    "fir_decim_mma_fwd") with launch parameters ``plan`` (kp, tpb) or (mtb,
    to, tpb) in stream mode ``cplx``."""
    from grtpu_torch.ops._build import library

    return _Plan(name, getattr(library(), name),
                 (b, total, g, k, decim, lead, nout,
                  _PRECISION_CODE[precision]) + tuple(plan) + (cplx,))


def _tile_launch(b: int, total: int, g: int, k: int, decim: int, lead: int,
                 nout: int, precision: str, plan, cplx: int = REAL) -> _Plan:
    """The launch of ``fir_tile_fwd`` with launch parameters ``plan``
    (threads, kblk) in stream mode ``cplx``."""
    from grtpu_torch.ops._build import library

    return _Plan("fir_tile_fwd", library().fir_tile_fwd,
                 (b, total, g, k, decim, lead, nout,
                  _PRECISION_CODE[precision]) + tuple(plan) + (cplx,))


@functools.lru_cache(maxsize=4096)
def _launch_plan(b: int, total: int, g: int, k: int, decim: int, lead: int,
                 nout: int, precision: str, index: int, fma: bool = False,
                 cplx: int = REAL):
    """The launch of one single-stage call, computed once per shape and
    stream mode: the route, the kernel's launch parameters and its
    shared-memory check.  ``index`` is the CUDA device's.  None when there is
    nothing to launch."""
    from grtpu_torch.ops._build import library

    lib = library()
    sms = _sm_count(index)
    route = _route(precision, decim, k, b, nout, fma, cplx)
    if route == "empty":
        return None
    if route == "toeplitz":
        return _toeplitz_launch(lib, b, total, g, k, lead, nout, precision, sms)
    if route == "decim_mma":
        return _decim_launch(
            "fir_decim_mma_fwd", b, total, g, k, decim, lead, nout, precision,
            _decim_mma_plan(precision, decim, k, b, nout, sms, cplx), cplx)
    if route == "decim_fma":
        return _decim_launch(
            "fir_decim_fwd", b, total, g, k, decim, lead, nout, precision,
            _decim_fma_plan(precision, decim, k, b, nout, sms, cplx), cplx)
    plan = _tile_plan(precision, decim, k, b, nout, sms, cplx)
    if plan is None:
        raise ValueError(f"decimation {decim} needs a window larger than "
                         f"shared memory")
    return _tile_launch(b, total, g, k, decim, lead, nout, precision, plan,
                        cplx)


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the integer a kernel
    launch takes.  A small chunk's launch is bound by the host, so the
    wrappers keep off the slower ``torch.cuda.current_stream(...)``."""
    return torch._C._cuda_getCurrentRawStream(index)


def _check(err: int, name: str):
    if err:
        from grtpu_torch.ops._build import library

        raise RuntimeError(f"{name} launch failed: "
                           + library().fir_error_string(err).decode())
    count_launch(name)


def count_launch(name: str):
    """Count one launch of kernel ``name``: in the record of the capture
    under way, if any (:func:`recording_launches`), else in ``launches``."""
    (_recording[-1] if _recording else launches)[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Count the launches made inside the block (a CUDA-graph capture) in
    the dict this yields, not in ``launches``: capture launches nothing.
    Hand the record to :func:`add_launches` at each replay of the graph."""
    record = dict.fromkeys(launches, 0)
    _recording.append(record)
    try:
        yield record
    finally:
        _recording.pop()


def add_launches(record):
    """Count one replay of a graph whose capture made ``record``."""
    for name, n in record.items():
        launches[name] += n


def _launch_tile(x, tapsets, decim, lead, nout, precision, _fma=False,
                 _plan=None, cplx=REAL):
    """Launch the single-stage FIR on the kernel :func:`_route` names
    (``_fma`` forces the CUDA cores, ``_plan`` another plan than
    :func:`_launch_plan`'s, both for timing choices side by side).  x: (B,
    total) contiguous; tapsets: (K,) or (G, K) float32 contiguous on x's
    device.  In the complex modes (``cplx`` CCF, CCC) x and the output are
    complex64, and the taps too in CCC."""
    b, total = x.shape
    g, k = (1, tapsets.shape[0]) if tapsets.ndim == 1 else tapsets.shape
    index = x.device.index
    x_bf16 = x.dtype == torch.bfloat16
    plan = _plan or _launch_plan(b, total, g, k, decim, lead, nout, precision,
                                 index, _fma, cplx)
    y = torch.empty((b, nout), device=x.device,
                    dtype=torch.complex64 if cplx else torch.float32)
    if plan is None:
        return y
    args = [x.data_ptr(), int(x_bf16), tapsets.data_ptr()]
    if plan.scratch:
        scratch = torch.empty(plan.scratch, dtype=torch.bfloat16,
                              device=x.device)
        args.append(scratch.data_ptr())
    args.append(y.data_ptr())
    if index == torch._C._cuda_getDevice():
        err = plan.fn(*args, *plan.args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = plan.fn(*args, *plan.args, _raw_stream(index))
    _check(err, plan.name)
    return y


def _launch_toeplitz(x, tapsets, lead, nout, precision):
    """The decimation-1 tensor-core route whatever the tap count (the routes
    side by side around ``_TZ_MIN_TAPS``)."""
    from grtpu_torch.ops._build import library

    b, total = x.shape
    g, k = tapsets.shape
    plan = _toeplitz_launch(library(), b, total, g, k, lead, nout, precision,
                            _sm_count(x.device.index))
    return _launch_tile(x, tapsets, 1, lead, nout, precision, _plan=plan)


def _cascade_mma_tile(n: int, k: int, nstages: int) -> int:
    """Outputs per block of the cascade's tensor-core route: the tile and its
    ``nstages*(k-1)`` samples of lookback fill the 128 rows of 128 samples
    that one stage's product spans.  0 when the lookback leaves no room for
    a tile."""
    tile = (_TZ_PASS_ROWS * LANE - nstages * (k - 1)) // LANE * LANE
    return max(0, min(tile, -(-n // LANE) * LANE))


@functools.lru_cache(maxsize=4096)
def _cascade_plan(n: int, k: int, nstages: int, precision: str, b: int = 16,
                  sms: int = _H100_SMS):
    """(tile, threads) of the cascade's FMA route.  Every tile recomputes its
    ``nstages*(k-1)`` lookback, about half of it a stage, so longer tiles
    waste less; but the grid runs in waves of as many blocks as the card
    holds, and a last wave that is nearly empty wastes more.  Of the tiles
    (multiples of 1024) whose two buffers fit shared memory, take the one
    with the largest kept share of the work times filled share of the
    waves; 1024 threads from 8192 outputs a tile (a stage's groups of 8
    outputs come to two or three rounds), fewer below."""
    halo = nstages * (k - 1)
    best = None
    for tile in range(1024, 32768 + 1, 1024):
        smem = _cascade_smem(precision, k, nstages, tile)
        if smem > _SMEM_OPTIN:
            break
        threads = 1024 if tile >= 8192 else 512 if tile >= 4096 else 256
        resident = sms * max(1, min(233472 // (smem + 1024), 2048 // threads))
        blocks = b * -(-n // tile)
        score = (tile / (tile + halo / 2)
                 * blocks / (-(-blocks // resident) * resident))
        if best is None or score >= best[0]:
            best = (score, tile, threads)
    if best is None:
        raise ValueError(f"{nstages} stages of {k} taps do not fit in "
                         f"shared memory")
    _, tile, threads = best
    if tile >= n:
        tile = -(-n // 256) * 256
        threads = min(threads, 256 if tile < 4096 else 512)
    return tile, threads


def _launch_cascade(x, taps, nstages, precision, _fma=False, _plan=None):
    """Launch the cascade: the tensor-core route for bf16 and bf16x3 (unless
    ``_fma`` forces the FMA route, for timing the two side by side, or the
    taps or the lookback do not fit), else the FMA route (``_plan``: another
    (tile, threads) than :func:`_cascade_plan`'s)."""
    from grtpu_torch.ops._build import library

    lib = library()
    b, n = x.shape
    k = taps.shape[-1]
    code = _PRECISION_CODE[precision]
    index = x.device.index
    tile = 0 if precision == "f32" or _fma else _cascade_mma_tile(n, k, nstages)
    mma = tile > 0 and k <= _TZ_MAX_TAPS[precision]
    y = torch.empty((b, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(index):
        stream = _raw_stream(index)
        if mma:
            err = lib.fir_cascade_mma_fwd(
                x.data_ptr(), taps.data_ptr(), y.data_ptr(), b, n, k, nstages,
                tile, code, stream)
        else:
            tile, threads = _plan or _cascade_plan(
                n, k, nstages, precision, b, _sm_count(index))
            err = lib.fir_cascade_fwd(
                x.data_ptr(), taps.data_ptr(), y.data_ptr(), b, n, k, nstages,
                tile, code, threads, stream)
    _check(err, "fir_cascade_mma_fwd" if mma else "fir_cascade_fwd")
    return y


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no FIR kernel for device {x.device}")
    return x.device.type


def _tile(x, taps, decim, lead, nout, precision):
    """Run the single-stage kernel on CUDA tensors, its twin on CPU tensors."""
    _check_precision(precision)
    if x.dtype == torch.bfloat16:
        if precision != "bf16":
            raise ValueError("bf16-resident streams need precision='bf16' "
                             "(the split-word lo plane needs the f32 residual)")
    elif x.dtype != torch.float32:
        raise TypeError(f"expected a float32 or bfloat16 stream, got {x.dtype}")
    if _device_kind(x) == "cpu":
        return fir_tile_ref(x, _tapsets(taps, x.device), decim, lead, nout,
                            precision)
    if not (isinstance(taps, torch.Tensor) and taps.dtype == torch.float32
            and taps.device == x.device and taps.is_contiguous()):
        taps = _tapsets(taps, x.device)
    return _launch_tile(x.contiguous(), taps, decim, lead, nout, precision)


# ------------------------------------------------------------- public API
def fir_cascade(x: torch.Tensor, taps, nstages: int, tile_rows: int = 256,
                precision: str = "f32") -> torch.Tensor:
    """Apply ``nstages`` sequential FIRs (same taps) to each row of x.

    Args:
      x: (batch, n) float32, n a multiple of 128 (or bfloat16 with
        nstages=1 and precision="bf16": the bf16-resident stream).  Zero
        history assumed; each stage produces full-rate output like chained
        fir_filter_fff blocks.
      taps: the taps (convolution orientation).
      nstages: number of chained stages.
      precision: "f32", "bf16x3" or "bf16".

    Returns (batch, n) float32.
    """
    if x.ndim == 1:
        return fir_cascade(x[None, :], taps, nstages, tile_rows, precision)[0]
    _check_precision(precision)
    if x.dtype == torch.bfloat16 and (nstages != 1 or precision != "bf16"):
        raise ValueError("bf16-resident streams need nstages=1 and "
                         "precision='bf16' (the split-word lo plane needs "
                         "the f32 residual)")
    n = x.shape[1]
    if n % LANE:
        raise ValueError("stream length must be a multiple of 128")
    k = np.shape(taps)[-1]
    if nstages == 1:
        return _tile(x, taps, 1, k - 1, n, precision)
    if x.dtype != torch.float32:
        raise TypeError(f"expected a float32 stream, got {x.dtype}")
    taps_t = _tapsets(taps, x.device)[0]
    if _device_kind(x) == "cpu":
        return fir_cascade_ref(x, taps_t, nstages, precision)
    return _launch_cascade(x.contiguous(), taps_t, nstages, precision)


def fir_long(x: torch.Tensor, taps, tile_rows: int = 1024,
             precision: str = "bf16x3") -> torch.Tensor:
    """History-carrying single-stage FIR with the
    grtpu_torch.ops.fir.fir_filter contract: ``x`` carries K-1 leading
    history samples and the output has ``len(x) - K + 1`` samples,
    ``y[i] = sum_k taps[k] x[i + K-1 - k]``."""
    k = np.shape(taps)[-1]
    return _tile(x[None, :], taps, 1, 0, x.shape[0] - (k - 1), precision)[0]


def batch_fir_long(x: torch.Tensor, taps, tile_rows: int = 1024,
                   precision: str = "bf16x3") -> torch.Tensor:
    """fir_long over a channel batch: x (C, n + K - 1) -> (C, n)."""
    k = np.shape(taps)[-1]
    return _tile(x, taps, 1, 0, x.shape[1] - (k - 1), precision)


def _phase_split_taps(taps: np.ndarray, d: int) -> np.ndarray:
    """Decompose a decimating FIR into d per-phase full-rate FIRs on the
    d interleaved substreams z_p[e] = x[e*d + p]:

        y[j] = sum_k taps[k] x[j*d + K-1 - k]
             = sum_p sum_i h[p, i] z_p[j + L-1 - i]

    (classic polyphase decimation).  Returns h (d, L).  The Hopper kernel
    decimates directly and does not need it; it stays for callers that
    build per-phase filter banks."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    L = (k - 1) // d + 1
    h = np.zeros((d, L), np.float32)
    for kk in range(k):
        p = (k - 1 - kk) % d
        sft = (k - 1 - kk - p) // d
        h[p, L - 1 - sft] = taps[kk]
    return h


def fir_decim(x: torch.Tensor, taps, decim: int, tile_rows: int = 1024,
              precision: str = "bf16x3") -> torch.Tensor:
    """Decimating FIR with the fir_filter contract: x (C, n + K - 1) or
    (n + K - 1,) carries K-1 leading history, returns n // decim outputs.
    The kernel computes only the decimated outputs (stride ``decim``)."""
    if x.ndim == 1:
        return fir_decim(x[None, :], taps, decim, tile_rows, precision)[0]
    d = int(decim)
    k = np.shape(taps)[-1]
    n = x.shape[1] - (k - 1)
    if n % d:
        raise ValueError("fresh input must be a multiple of decim")
    return _tile(x, taps, d, 0, n // d, precision)


def _complex_taps(taps, device, cplx: int) -> torch.Tensor:
    """The taps of a complex-mode launch: ccf (G, K) or (K,) float32, ccc
    complex64, used in place where they are a contiguous tensor of that
    type on ``device`` already (the block keeps its taps so)."""
    dtype = torch.complex64 if cplx == CCC else torch.float32
    if (isinstance(taps, torch.Tensor) and taps.dtype == dtype
            and taps.device == device and taps.is_contiguous()):
        return taps
    if cplx == CCC:
        return torch.as_tensor(taps).to(device=device,
                                        dtype=dtype).contiguous()
    return _tapsets(taps, device)


def _decim_complex(x, taps, decim, precision, cplx, _force_planes=False):
    """``fir_decim_c`` (ccf) and ``fir_decim_cc`` (ccc) on a (C, n + K - 1)
    complex64 stream, channel c on tap set c % G of (G, K) taps for both
    its planes, on every route.  A ccc call with real taps takes ccf, whose
    sums are the same (the ti plane is zero).  On the card: one launch of
    the kernel :func:`_route` names in its complex mode.  Elsewhere (the
    CPU, where the twins run; on the card :func:`_route`'s "planes"
    shapes, or any shape with ``_force_planes``, which is there for timing
    this path beside the launch) the real FIR over the stacked planes,
    rows c and C + c: ccf one pass, ccc one a tap plane.  The real FIR
    gives row r set r % G, which is c % G for row C + c only where G
    divides C; otherwise the sets are first laid out one a plane row."""
    _check_precision(precision)
    if x.dtype != torch.complex64:
        raise TypeError(f"expected a complex64 stream, got {x.dtype}")
    if isinstance(taps, torch.Tensor):
        if not taps.is_complex():
            cplx = CCF
    else:
        taps = np.asarray(taps)
        if not np.iscomplexobj(taps):
            cplx = CCF
    d = int(decim)
    k = taps.shape[-1]
    c, total = x.shape
    n = total - (k - 1)
    if n % d:
        raise ValueError("fresh input must be a multiple of decim")
    if (_device_kind(x) == "cuda" and not _force_planes
            and _route(precision, d, k, c, n // d, cplx=cplx) != "planes"):
        tapsets = _complex_taps(taps, x.device, cplx)
        y = _launch_tile(x.contiguous(), tapsets, d, 0, n // d, precision,
                         cplx=cplx)
        if cplx == CCC:
            count_launch("fir_decim_cc")
        return y
    planes = torch.cat([x.real, x.imag], dim=0)
    if taps.ndim == 2 and c % taps.shape[0]:
        rows = torch.arange(c, device=x.device) % taps.shape[0]
        taps = _complex_taps(taps, x.device, cplx)[rows].repeat(2, 1)
    if cplx == CCF:
        y = fir_decim(planes, taps, d, precision=precision)
        return torch.complex(y[:c], y[c:])
    yr = fir_decim(planes, taps.real, d, precision=precision)
    yi = fir_decim(planes, taps.imag, d, precision=precision)
    return torch.complex(yr[:c] - yi[c:], yi[:c] + yr[c:])


def fir_decim_c(x: torch.Tensor, taps, decim: int = 1, tile_rows: int = 1024,
                precision: str = "bf16x3") -> torch.Tensor:
    """Complex-stream real-taps (ccf) FIR with optional decimation: x (C,
    n + K - 1) or (n + K - 1,) complex64 carrying K-1 history, n // decim
    outputs.  Row c takes tap set c % G of (G, K) taps, for its re and im
    planes alike, on every route.  On the card one launch reads the
    interleaved stream and writes the complex64 output (but for
    :func:`_route`'s "planes" shapes); on the CPU the two real planes ride
    the real twin as extra batch rows."""
    if x.ndim == 1:
        return fir_decim_c(x[None, :], taps, decim, tile_rows, precision)[0]
    return _decim_complex(x, taps, decim, precision, CCF)


def fir_decim_cc(x: torch.Tensor, taps, decim: int = 1, tile_rows: int = 1024,
                 precision: str = "bf16x3") -> torch.Tensor:
    """Complex-stream complex-taps (ccc): (r*tr - i*ti) + j(r*ti + i*tr),
    row c on tap set c % G of (G, K) taps for both planes, on every route.
    On the card one launch over both tap planes reads the interleaved stream
    and writes the complex64 output (but for :func:`_route`'s "planes"
    shapes); on the CPU the real twin runs once per tap plane over the
    stacked re / im planes."""
    if x.ndim == 1:
        return fir_decim_cc(x[None, :], taps, decim, tile_rows, precision)[0]
    return _decim_complex(x, taps, decim, precision, CCC)
