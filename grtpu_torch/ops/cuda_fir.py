"""Hopper FIR kernels behind the public API of ``grtpu.ops.pallas_fir``.

Port of ``grtpu.ops.pallas_fir``: the same public functions and signatures
minus ``interpret`` — ``fir_cascade``, ``fir_long``, ``batch_fir_long``,
``fir_decim``, ``fir_decim_c``, ``fir_decim_cc`` and ``_phase_split_taps`` —
over the CUDA C++ kernels in ``grtpu_torch/csrc/fir_tile.cu``:

* ``fir_tile_fwd``     — one FIR per batch row (row i uses tap set i % G),
  with a decimation stride and an optional zero lead, f32 or bf16 input,
  float32 FMAs on the CUDA cores.  It serves every single-stage path:
  fir_long, fir_decim (decimated outputs computed directly, no phase
  split), the complex plane variants and fir_cascade with one stage.
* ``fir_toeplitz_fwd`` — the same single-stage FIR at decimation 1 in bf16
  and bf16x3, on the tensor cores: rows of the stream against the Toeplitz
  matrix of the taps.  ``_launch_tile`` sends those calls here.
* ``fir_cascade_fwd``  — S chained FIRs with the same taps from zero
  history, the stages resident in shared memory, float32 FMAs (f32).
* ``fir_cascade_mma_fwd`` — the same cascade in bf16 and bf16x3, each stage
  the tensor-core product of ``fir_toeplitz_fwd``.

Every public function holds the contract ``y[i] = sum_k taps[k] *
x[i*d + K-1-k]`` (x carrying K-1 samples of history, or zero history for
fir_cascade); the TPU kernel's halo and orientation bookkeeping
(``_pad_taps``, ``_tap_group``, the 8-sublane rounding) has no counterpart.

Dispatch is by the tensor's device: a CPU tensor runs the kernel's plain
PyTorch twin (:func:`fir_tile_ref`, :func:`fir_cascade_ref`); a CUDA tensor
launches the kernel, building it at first use, or raises.
:func:`fir_toeplitz_ref` is the plain form of the tensor-core route's own
arithmetic and layout.  ``launches`` counts the kernel launches, one per
launch under the name of the entry that was called, for callers that must
show a path went through the kernels.

``tile_rows`` is accepted for grtpu signature compatibility; the Hopper
kernels size their tiles from shared memory and the batch instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from grtpu_torch.ops.fir import (PRECISIONS, fir_filter, pad_last,
                                 real_matmul)

LANE = 128

# Kernel launch counts, by the name of the C entry that was called.
launches = {"fir_tile_fwd": 0, "fir_toeplitz_fwd": 0, "fir_cascade_fwd": 0,
            "fir_cascade_mma_fwd": 0}

_PRECISION_CODE = {"f32": 0, "bf16": 1, "bf16x3": 2}
_THREADS = 256
_KBLK = 2048             # taps staged in shared memory per pass
_MAX_TILE_SPAN = 4096    # input samples a fir_tile_fwd window spans, at most
_SMEM_OPTIN = 232448     # bytes of shared memory a Hopper block may opt into
_CASCADE_TILES = (8192, 4096, 2048, 1024, 512, 256)  # largest that fits wins
_TZ_PASS_ROWS = 128      # output rows of 128 a tensor-core block computes per pass
_H100_SMS = 132          # blocks are sized for this many SMs off the card
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
def _toeplitz_plan(b: int, nout: int, k: int, sms: int = _H100_SMS):
    """Layout of the tensor-core route for ``b`` rows of ``nout`` outputs and
    ``k`` taps: the stream is read as rows of 128 samples behind ``lead``
    zeros, an output row needs ``nh`` consecutive stream rows, and the output
    rows of a batch row are cut into ``nseg`` segments of ``seg_rows`` (a
    multiple of the rows a block computes per pass), about two blocks an SM.
    Returns (nh, seg_rows, nseg, lrows); ``lrows`` is the number of stream
    rows staged per batch row, zero-filled past the data."""
    nh = -(-(k + LANE - 1) // LANE)
    rows = max(1, -(-nout // LANE))
    passes = -(-rows // _TZ_PASS_ROWS)
    segs = max(1, min(2 * sms // max(b, 1), passes))
    seg_rows = -(-passes // segs) * _TZ_PASS_ROWS
    nseg = -(-rows // seg_rows)
    return nh, seg_rows, nseg, nseg * seg_rows + nh - 1


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


# --------------------------------------------------------------- launches
def _toeplitz_smem(precision: str, k: int) -> int:
    """Bytes of shared memory one block of the tensor-core routes uses for
    ``k`` taps (fir_tile.cu's ``toeplitz_smem``): the tap words of each plane
    in two parity copies, rounded up to 1024, then two stages of swizzled
    rows, 256 bytes a row and plane."""
    npl = 2 if precision == "bf16x3" else 1
    nh = -(-(k + LANE - 1) // LANE)
    tap_words = LANE // 2 * (nh + 1) + 16
    tap_bytes = -(-npl * 2 * 4 * tap_words // 1024) * 1024
    rows = -(-(_TZ_PASS_ROWS + nh - 1) // 8) * 8
    return tap_bytes + 2 * npl * 2 * rows * LANE


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raw_stream(device) -> int:
    """The current CUDA stream of ``device`` as the integer a kernel launch
    takes.  A small chunk's launch is bound by the host, so the wrappers
    keep off the slower ``torch.cuda.current_stream(...).cuda_stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch_toeplitz(x, tapsets, lead, nout, precision):
    from grtpu_torch.ops._build import library

    lib = library()
    b, total = x.shape
    g, k = tapsets.shape
    nh, seg_rows, nseg, lrows = _toeplitz_plan(b, nout, k, _sm_count(x.device))
    assert seg_rows % lib.fir_toeplitz_rows_per_pass() == 0
    planes = 2 if precision == "bf16x3" else 1
    scratch = torch.empty((planes, b, lrows * LANE), dtype=torch.bfloat16,
                          device=x.device)
    y = torch.empty((b, nout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = _raw_stream(x.device)
        err = lib.fir_toeplitz_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), tapsets.data_ptr(),
            scratch.data_ptr(), y.data_ptr(), b, total, g, k, lead, nout,
            _PRECISION_CODE[precision], seg_rows, nseg, lrows, stream)
    if err:
        raise RuntimeError("fir_toeplitz_fwd launch failed: "
                           + lib.fir_error_string(err).decode())
    launches["fir_toeplitz_fwd"] += 1
    return y


def _launch_tile(x, tapsets, decim, lead, nout, precision, _fma=False):
    """Launch the single-stage FIR: the tensor-core route for bf16 and bf16x3
    at decimation 1 and ``_TZ_MIN_TAPS`` to ``_TZ_MAX_TAPS`` taps (unless
    ``_fma`` forces the FMA route, for timing the two side by side), else the
    FMA route."""
    from grtpu_torch.ops._build import library

    lib = library()
    b, total = x.shape
    g, k = tapsets.shape
    code = _PRECISION_CODE[precision]
    if (decim == 1 and precision != "f32" and not _fma and nout and b
            and _TZ_MIN_TAPS <= k <= _TZ_MAX_TAPS[precision]):
        return _launch_toeplitz(x, tapsets, lead, nout, precision)
    opt = lib.fir_tile_outputs_per_thread()
    # bound the window a tile spans, then shrink tiles until the grid fills
    # the card twice over (or the tiles reach one warp)
    threads = _THREADS
    while threads > 32 and threads * opt * decim > _MAX_TILE_SPAN:
        threads //= 2
    while threads > 32 and b * -(-nout // (threads * opt)) < 2 * _sm_count(
            x.device):
        threads //= 2
    kblk = min(k, _KBLK)
    if lib.fir_tile_smem(code, threads, decim, kblk) > _SMEM_OPTIN:
        raise ValueError(f"decimation {decim} needs a window larger than "
                         f"shared memory")
    y = torch.empty((b, nout), dtype=torch.float32, device=x.device)
    if nout == 0 or b == 0:
        return y
    with torch.cuda.device(x.device):
        stream = _raw_stream(x.device)
        err = lib.fir_tile_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), tapsets.data_ptr(),
            y.data_ptr(), b, total, g, k, decim, lead, nout, code, threads,
            kblk, stream)
    if err:
        raise RuntimeError("fir_tile_fwd launch failed: "
                           + lib.fir_error_string(err).decode())
    launches["fir_tile_fwd"] += 1
    return y


def _cascade_mma_tile(n: int, k: int, nstages: int) -> int:
    """Outputs per block of the cascade's tensor-core route: the tile and its
    ``nstages*(k-1)`` samples of lookback fill the 128 rows of 128 samples
    that one stage's product spans.  0 when the lookback leaves no room for
    a tile."""
    tile = (_TZ_PASS_ROWS * LANE - nstages * (k - 1)) // LANE * LANE
    return max(0, min(tile, -(-n // LANE) * LANE))


def _launch_cascade(x, taps, nstages, precision, _fma=False):
    """Launch the cascade: the tensor-core route for bf16 and bf16x3 (unless
    ``_fma`` forces the FMA route, for timing the two side by side, or the
    taps or the lookback do not fit), else the FMA route."""
    from grtpu_torch.ops._build import library

    lib = library()
    b, n = x.shape
    k = taps.shape[-1]
    code = _PRECISION_CODE[precision]
    tile = 0 if precision == "f32" or _fma else _cascade_mma_tile(n, k, nstages)
    mma = tile > 0 and k <= _TZ_MAX_TAPS[precision]
    if not mma:
        # the largest tile whose S*(K-1) lookback fits shared memory: the
        # lookback is recomputed by every tile, so longer tiles waste less
        for tile in _CASCADE_TILES:
            if lib.fir_cascade_smem(code, k, nstages, tile) <= _SMEM_OPTIN:
                break
        else:
            raise ValueError(f"{nstages} stages of {k} taps do not fit in "
                             f"shared memory")
        tile = min(tile, -(-n // 256) * 256)
    y = torch.empty((b, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = _raw_stream(x.device)
        if mma:
            err = lib.fir_cascade_mma_fwd(
                x.data_ptr(), taps.data_ptr(), y.data_ptr(), b, n, k, nstages,
                tile, code, stream)
        else:
            err = lib.fir_cascade_fwd(
                x.data_ptr(), taps.data_ptr(), y.data_ptr(), b, n, k, nstages,
                tile, code, _THREADS, stream)
    name = "fir_cascade_mma_fwd" if mma else "fir_cascade_fwd"
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.fir_error_string(err).decode())
    launches[name] += 1
    return y


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no FIR kernel for device {x.device}")
    return x.device.type


def _tile(x, taps, decim, lead, nout, precision):
    """Run fir_tile_fwd on CUDA tensors, its twin on CPU tensors."""
    _check_precision(precision)
    if x.dtype == torch.bfloat16:
        if precision != "bf16":
            raise ValueError("bf16-resident streams need precision='bf16' "
                             "(the split-word lo plane needs the f32 residual)")
    elif x.dtype != torch.float32:
        raise TypeError(f"expected a float32 or bfloat16 stream, got {x.dtype}")
    tapsets = _tapsets(taps, x.device)
    if _device_kind(x) == "cpu":
        return fir_tile_ref(x, tapsets, decim, lead, nout, precision)
    return _launch_tile(x.contiguous(), tapsets, decim, lead, nout, precision)


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


def fir_decim_c(x: torch.Tensor, taps, decim: int = 1, tile_rows: int = 1024,
                precision: str = "bf16x3") -> torch.Tensor:
    """Complex-stream real-taps (ccf) FIR with optional decimation: the two
    real planes ride the same kernel grid as extra batch rows."""
    if x.ndim == 1:
        return fir_decim_c(x[None, :], taps, decim, tile_rows, precision)[0]
    planes = torch.cat([x.real, x.imag], dim=0)
    y = fir_decim(planes, taps, decim, tile_rows, precision)
    c = x.shape[0]
    return torch.complex(y[:c], y[c:])


def fir_decim_cc(x: torch.Tensor, taps, decim: int = 1, tile_rows: int = 1024,
                 precision: str = "bf16x3") -> torch.Tensor:
    """Complex-stream complex-taps (ccc): (r*tr - i*ti) + j(r*ti + i*tr),
    one kernel launch per tap plane over the stacked re/im planes."""
    if x.ndim == 1:
        return fir_decim_cc(x[None, :], taps, decim, tile_rows, precision)[0]
    if isinstance(taps, torch.Tensor):
        tr, ti = taps.real, taps.imag
    else:
        taps = np.asarray(taps)
        tr, ti = np.real(taps), np.imag(taps)
    planes = torch.cat([x.real, x.imag], dim=0)
    yr = fir_decim(planes, tr, decim, tile_rows, precision)
    yi = fir_decim(planes, ti, decim, tile_rows, precision)
    c = x.shape[0]
    return torch.complex(yr[:c] - yi[c:], yi[:c] + yr[c:])
