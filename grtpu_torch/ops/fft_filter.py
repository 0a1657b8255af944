"""FFT-domain FIR: overlap-save fast convolution on ``torch.fft``.

Port of ``grtpu.ops.fft_filter``.  Overlap-save is stateless given the
executor-managed history halo, so ``fir_filter`` and ``fft_filter`` are
drop-in interchangeable per chunk.

Contract matches :func:`grtpu_torch.ops.fir.fir_filter` exactly
(convolution form): input length n + K - 1 -> output length n // decim,
y[i] = sum_k taps[k] * x[i*decim + K - 1 - k].
"""

from __future__ import annotations

import torch

from grtpu_torch.ops.fir import _window_matrix, as_taps, pad_last


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_filter(x: torch.Tensor, taps, decim: int = 1,
               fftsize: int | None = None) -> torch.Tensor:
    """Overlap-save fast convolution; see module docstring for the contract."""
    taps = as_taps(taps, x.device)
    k = taps.shape[0]
    n = x.shape[0] - (k - 1)
    if n <= 0:
        raise ValueError("input shorter than taps")
    nout = n // decim
    if fftsize is None:
        fftsize = max(2 * _next_pow2(k), 256)
    L = fftsize - k + 1  # valid outputs per segment

    nseg = -(-n // L)
    need = (nseg - 1) * L + fftsize
    xp = pad_last(x, 0, max(0, need - x.shape[0]))

    # segments of length fftsize with stride L: segment s covers outputs
    # [s*L, s*L + L) and needs inputs [s*L, s*L + fftsize)
    segs = _window_matrix(xp[:nseg * L + fftsize - L], fftsize - L + 1, L)

    complex_in = x.is_complex() or taps.is_complex()
    hp = pad_last(taps, 0, fftsize - k).to(torch.complex64)
    H = torch.fft.fft(hp)
    X = torch.fft.fft(segs.to(torch.complex64), dim=1)
    Y = torch.fft.ifft(X * H[None, :], dim=1)
    # valid (fully-overlapped) outputs of each segment: k-1 .. fftsize-1
    y = Y[:, k - 1:].reshape(-1)[:n]
    if decim != 1:
        y = y[::decim][:nout]
    if complex_in:
        return y.to(torch.complex64)
    return y.real.to(torch.float32).contiguous()
