"""Hopper kernel for the constant, stable first-order IIR.

``iir1_fwd`` (``csrc/iir1.cu``) replaces no Pallas kernel: grtpu solves
``y[i] = a*y[i-1] + v[i]`` for a constant stable pole with XLA ops (the
truncated impulse response as a Toeplitz product, ``grtpu.ops.dsp.
linear_recurrence_const``), which the port ran as ~20 small launches a
chunk.  One launch computes, over the rows of ``x`` (leading axes
flattened), the feed-forward sum ``v`` over the history and the chunk, the
truncated response ``sum_k a^k v[i-k]`` and the carried state's
``a^(i+1) y0``: see the source's note for the design.

Its plain twin is the code ``grtpu_torch.ops.dsp`` runs on a CPU tensor
(``linear_recurrence_const``'s truncated branch, ``iir_filter``'s
first-order branch), which routes a CUDA tensor here.  This wrapper
launches the kernel or raises: there is no fallback.  Each launch is
counted in ``grtpu_torch.ops.cuda_fir.launches`` under ``iir1_fwd`` (in the
open record of a CUDA-graph capture, if any).
"""

from __future__ import annotations

import functools

import torch

from grtpu_torch.ops.cuda_fir import (_H100_SMS, _raw_stream, _sm_count,
                                      count_launch)

_R = 8                   # consecutive outputs of one plane a thread
SMEM_OPTIN = 232448      # bytes of shared memory a block may take on Hopper


def layout(threads: int, cplx: bool, k: int, nff: int):
    """``csrc/iir1.cu``'s ``layout``: the float offsets of a block's taps,
    feed-forward taps, staged window and skewed v in shared memory, and its
    total, for ``threads`` threads, K = ``k`` and ``nff`` feed-forward
    taps."""
    c = 2 if cplx else 1
    kp = -(-k // _R) * _R
    t = threads * _R // c
    vn = t + kp - 1
    taps, ff = 0, kp
    xs = ff + _round4(nff)
    v = xs + _round4(3 + (vn + nff - 1) * c + 3)
    f = vn * c
    return taps, ff, xs, v, v + f + f // (_R * c) + 1


def _round4(v: int) -> int:
    return (v + 3) & ~3


@functools.lru_cache(maxsize=1024)
def threads_for(rows: int, n: int, cplx: bool, sms: int = _H100_SMS) -> int:
    """Threads a block for ``rows`` x ``n`` samples: the most, up to 128,
    that still give the card two blocks an SM (a tile is threads * 8
    outputs, half that many samples of a complex row), else one warp."""
    for threads in (128, 64):
        tile = threads * _R // (2 if cplx else 1)
        if rows * -(-n // tile) >= 2 * sms:
            return threads
    return 32


def _library():
    from grtpu_torch.ops._build import library

    return library()


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _y0_args(y0, x: torch.Tensor, lead):
    """(tensor on the card, stride) for the kernel's y0: one value for all
    rows (a number, made on the card without a host-to-device copy, or a
    tensor of one value) or one a row."""
    if not isinstance(y0, torch.Tensor):
        return torch.full((1,), y0, dtype=x.dtype, device=x.device), 0
    y0 = y0.to(device=x.device, dtype=x.dtype)
    if y0.numel() == 1:
        return y0.reshape(1), 0
    return torch.broadcast_to(y0, lead).contiguous(), 1


def iir1_fwd(x: torch.Tensor, x_hist, ff, apow: torch.Tensor,
             apow1: torch.Tensor, y0):
    """One launch of ``iir1_fwd`` over ``x`` (..., n) float32 or complex64
    on the card.  ``x_hist`` (..., nff - 1) is the history before the chunk
    and ``ff`` (nff,) float32 the feed-forward taps on the card, or both
    None for v = x; ``apow`` and ``apow1`` are a^0..a^(K-1) and a^1..a^K
    float32 on the card; ``y0`` the state before the chunk (a number, one
    value, or one a row).  Returns (y, the next call's x history or
    None).  Raises ValueError where the block's staged window would
    outgrow shared memory (:func:`layout`; some 18,000 feed-forward taps on
    a complex row, 27,000 on a real one)."""
    if x.device.type != "cuda":
        raise ValueError(f"iir1_fwd runs on a CUDA tensor, not {x.device}")
    if x.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"iir1_fwd takes float32 or complex64 rows, not "
                        f"{x.dtype}")
    if ff is not None and (ff.dtype != torch.float32 or ff.ndim != 1):
        raise TypeError("iir1_fwd takes (nff,) float32 feed-forward taps")
    for name, t in (("ff", ff), ("apow", apow), ("apow1", apow1)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    k = apow.shape[0]
    if apow.dtype != torch.float32 or apow1.dtype != torch.float32 \
            or apow1.shape[0] != k or k < 1:
        raise TypeError("iir1_fwd takes K >= 1 float32 powers a^k and a^(k+1)")
    nff = 1 if ff is None else ff.shape[0]
    lead, n = x.shape[:-1], x.shape[-1]
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // n if n else 0
    if rows == 0:
        return y, None if nff == 1 else x_hist
    hist = hist_out = None
    if nff > 1:
        if x_hist is None or x_hist.shape != lead + (nff - 1,):
            raise ValueError(f"x_hist must be {tuple(lead) + (nff - 1,)}")
        hist = x_hist.to(device=x.device, dtype=x.dtype).contiguous()
        hist_out = torch.empty_like(hist)
    cplx = x.is_complex()
    index = x.device.index
    threads = threads_for(rows, n, cplx, _sm_count(index))
    if 4 * layout(threads, cplx, k, nff)[-1] > SMEM_OPTIN:
        raise ValueError(f"iir1_fwd: {nff} feed-forward taps do not fit a "
                         f"block's shared memory ({SMEM_OPTIN} bytes)")
    y0_t, y0_stride = _y0_args(y0, x, lead)
    lib = _library()
    if ff is not None:
        ff = ff.contiguous()
    args = (x.data_ptr(), _ptr(hist), _ptr(ff), nff, apow.data_ptr(),
            apow1.data_ptr(), k, y0_t.data_ptr(), y0_stride, rows, n,
            int(cplx), threads, y.data_ptr(), _ptr(hist_out))
    if index == torch._C._cuda_getDevice():
        err = lib.iir1_fwd(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = lib.iir1_fwd(*args, _raw_stream(index))
    if err:
        raise RuntimeError("iir1_fwd launch failed: "
                           + lib.iir1_error_string(err).decode())
    count_launch("iir1_fwd")
    return y, hist_out
