"""FIR filtering as Toeplitz block matmuls, in PyTorch.

Port of ``grtpu.ops.fir`` (``fir_filter``, ``batch_fir_filter``,
``interp_fir_filter``, ``fir_filterbank``, ``freq_xlating_fir_filter``,
``rotate_taps``, ``compose_taps``, ``compose_taps_power``).  The formulation is grtpu's: for
a block of B consecutive outputs the correlation

    y[m*B + b] = sum_k h[k] * x[m*B + b + k]

is one matmul ``Y = W @ T`` of the window matrix ``W[m, j] = x[m*B + j]``
(built from shifted reshapes, no gather) and the constant tap matrix
``T[j, b] = h[j - b]``.  Decimation folds the d polyphase branches into the
contraction axis of the same matmul.

Semantics (unchanged): an input of length ``n + K - 1`` carries its own
history and yields ``n // decim`` outputs in convolution orientation,
``y[i] = sum_k taps[k] * x[i*decim + K - 1 - k]``.  The port accepts any
number of leading batch dimensions ``(..., n + K - 1)``.

Precision is a per-call argument (grtpu keeps it in a module global set by
``set_precision``):

* ``"f32"``    — one float32 matmul.  On a CUDA tensor it refuses to run
  while TF32 is enabled for matmuls, since TF32 keeps about three decimal
  digits (the torch form of the lesson in grtpu's ``fir.py`` about XLA's
  single-pass bf16 default on the TPU).
* ``"bf16x3"`` — split-word 3-pass: ``w = wh + wl`` in bf16, products
  ``wh@th + wh@tl + wl@th`` taken in float32 on the bf16-rounded operands.
* ``"bf16"``   — single pass on bf16-rounded operands, float32 sums.
"""

from __future__ import annotations

import numpy as np
import torch

# Output-block width along the matmul N dimension (grtpu's MXU lane width;
# kept so the port sums in the same blocks).
_B = 128

PRECISIONS = ("f32", "bf16x3", "bf16")


def as_taps(taps, device) -> torch.Tensor:
    """Taps (numpy array, sequence or tensor) as a float32 or complex64
    tensor on ``device``."""
    if isinstance(taps, torch.Tensor):
        t = taps.to(device)
    else:
        t = torch.as_tensor(np.asarray(taps), device=device)
    if t.is_complex():
        return t.to(torch.complex64)
    return t.to(torch.float32)


def pad_last(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad the last axis (works for complex tensors too)."""
    if before == 0 and after == 0:
        return x
    parts = []
    if before:
        parts.append(x.new_zeros(x.shape[:-1] + (before,)))
    parts.append(x)
    if after:
        parts.append(x.new_zeros(x.shape[:-1] + (after,)))
    return torch.cat(parts, dim=-1)


def _tap_matrix(taps: torch.Tensor, block: int) -> torch.Tensor:
    """Build T[j, b] = taps[j - b], shape (K + block - 1, block)."""
    k = taps.shape[0]
    ncols = k + block - 1
    j = torch.arange(ncols, device=taps.device)[:, None]
    b = torch.arange(block, device=taps.device)[None, :]
    idx = j - b
    valid = (idx >= 0) & (idx < k)
    return torch.where(valid, taps[idx.clamp(0, k - 1)],
                       torch.zeros((), dtype=taps.dtype, device=taps.device))


def _window_matrix(x: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """W[..., m, j] = x[..., m*block + j] for j < k + block - 1.

    x has length M*block + k - 1 on its last axis; returns (..., M,
    k + block - 1), built from shifted reshapes (no gather)."""
    lead = x.shape[:-1]
    m = (x.shape[-1] - (k - 1)) // block
    ncols = k + block - 1
    nslices = -(-ncols // block)
    xp = pad_last(x, 0, nslices * block - ncols)
    cols = [xp[..., c * block:c * block + m * block].reshape(lead + (m, block))
            for c in range(nslices)]
    return torch.cat(cols, dim=-1)[..., :ncols]


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and widen back to float32."""
    return v.to(torch.bfloat16).to(torch.float32)


def check_no_tf32(x: torch.Tensor):
    """Raise if a float32 matmul on ``x``'s device would run in TF32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "precision='f32' refuses to run with "
            "torch.backends.cuda.matmul.allow_tf32 = True (TF32 keeps ~3 "
            "decimal digits); disable TF32 or pick precision='bf16x3'")


def real_matmul(w: torch.Tensor, t: torch.Tensor, precision: str = "f32"):
    """Real float32 matmul in the requested precision mode."""
    if precision == "f32":
        check_no_tf32(w)
        return w @ t
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    wh, th = _bf16(w), _bf16(t)
    if precision == "bf16":
        return wh @ th
    wl, tl = _bf16(w - wh), _bf16(t - th)
    return wh @ th + wh @ tl + wl @ th


def _matmul(w, t, precision):
    """Matmul with explicit complex decomposition (real float32 products)."""
    wc, tc = w.is_complex(), t.is_complex()
    if not wc and not tc:
        return real_matmul(w, t, precision)
    if wc and not tc:
        return torch.complex(real_matmul(w.real, t, precision),
                             real_matmul(w.imag, t, precision))
    if not wc and tc:
        return torch.complex(real_matmul(w, t.real, precision),
                             real_matmul(w, t.imag, precision))
    rr = real_matmul(w.real, t.real, precision)
    ii = real_matmul(w.imag, t.imag, precision)
    ri = real_matmul(w.real, t.imag, precision)
    ir = real_matmul(w.imag, t.real, precision)
    return torch.complex(rr - ii, ri + ir)


def _out_dtype(x_dtype, taps_dtype):
    if x_dtype.is_complex or taps_dtype.is_complex:
        return torch.complex64
    return torch.float32


def _block_for(nout: int) -> int:
    return _B if nout >= _B else max(8, 1 << max(0, (nout - 1).bit_length()))


# --------------------------------------------------------------------- direct
def fir_filter(x: torch.Tensor, taps, decim: int = 1,
               precision: str = "f32") -> torch.Tensor:
    """Decimating FIR (convolution form — standard FIR difference equation).

    Args:
      x: input of length ``n + ntaps - 1`` on its last axis (history
        included; n % decim == 0); leading axes are batch axes.
      taps: filter taps, length K (numpy array or tensor).
        ``y[i] = sum_k taps[k] x[i*decim + K - 1 - k]``.
      decim: keep one output per ``decim`` inputs.
      precision: "f32", "bf16x3" or "bf16" (see the module docstring).

    Returns: y of length n // decim on its last axis.
    """
    taps = torch.flip(as_taps(taps, x.device), dims=(0,))
    k = taps.shape[0]
    n = x.shape[-1] - (k - 1)
    if n < 0:
        raise ValueError(f"input too short for {k} taps")
    nout = n // decim
    if decim == 1:
        return _fir_block_matmul(x, taps, nout, precision)
    return _fir_polyphase_decim(x, taps, decim, nout, precision)


def _fir_block_matmul(x, taps, nout, precision):
    k = taps.shape[0]
    block = _block_for(nout)
    m = -(-nout // block)
    need = m * block + k - 1
    xp = pad_last(x, 0, need - x.shape[-1]) if need > x.shape[-1] else x
    w = _window_matrix(xp, k, block)
    t = _tap_matrix(taps, block)
    y = _matmul(w, t, precision).reshape(x.shape[:-1] + (-1,))
    return y[..., :nout].to(_out_dtype(x.dtype, taps.dtype))


def _fir_polyphase_decim(x, taps, d, nout, precision):
    """y[i] = sum_p fir(x[p::d], taps[p::d])[i] — folded into one matmul
    by concatenating the per-phase windows/taps on the contraction axis."""
    k = taps.shape[0]
    kp = -(-k // d)  # taps per phase
    tp = pad_last(taps, 0, kp * d - k)
    # phase streams x_p[t] = x[t*d + p], each nout + kp - 1 long
    need_per_phase = nout + kp - 1
    xp_ = pad_last(x, 0, max(0, need_per_phase * d - x.shape[-1]))
    phases = xp_[..., :need_per_phase * d].reshape(
        x.shape[:-1] + (need_per_phase, d))
    block = _block_for(nout)
    m = -(-nout // block)
    ws, ts = [], []
    for p in range(d):
        xph = phases[..., p]
        need = m * block + kp - 1
        xph = pad_last(xph, 0, max(0, need - xph.shape[-1]))
        ws.append(_window_matrix(xph, kp, block))
        ts.append(_tap_matrix(tp[p::d], block))
    w = torch.cat(ws, dim=-1)
    t = torch.cat(ts, dim=0)
    y = _matmul(w, t, precision).reshape(x.shape[:-1] + (-1,))
    return y[..., :nout].to(_out_dtype(x.dtype, taps.dtype))


def batch_fir_filter(x: torch.Tensor, taps, decim: int = 1,
                     precision: str = "f32") -> torch.Tensor:
    """Same filter over a batch of channels: x (C, n + K - 1) -> (C, n//decim).

    The window matrices of all channels stack on the matmul M axis."""
    return fir_filter(x, taps, decim, precision)


def interp_fir_filter(x: torch.Tensor, taps, interp: int,
                      precision: str = "f32") -> torch.Tensor:
    """Polyphase interpolating FIR (gr_interp_fir_filter_XXX semantics).

    Args:
      x: input of length ``n + ceil(K/L) - 1`` on its last axis (history =
        taps per phase); leading axes are batch axes.
      taps: prototype taps, length K (zero-padded to a multiple of L).
      interp: L outputs per input.
      precision: "f32", "bf16x3" or "bf16" (see the module docstring).

    Returns y of length n * L on its last axis, exactly upsample-by-L then
    convolution with ``taps``: ``y[i*L + p] = sum_c taps[p + c*L] x[i - c]``.
    The L phase tap matrices sit side by side on the matmul's output axis.
    """
    l = interp
    taps = as_taps(taps, x.device)
    k = taps.shape[0]
    kp = -(-k // l)
    n = x.shape[-1] - (kp - 1)
    tp = pad_last(taps, 0, kp * l - k)
    block = _block_for(n)
    m = -(-n // block)
    need = m * block + kp - 1
    xp = pad_last(x, 0, max(0, need - x.shape[-1]))
    w = _window_matrix(xp, kp, block)                 # (..., m, kp+block-1)
    t = torch.cat([_tap_matrix(torch.flip(tp[p::l], dims=(0,)), block)
                   for p in range(l)], dim=1)         # (kp+block-1, l*block)
    y = _matmul(w, t, precision)                      # (..., m, l*block)
    # y[..., i, p*block + b] is phase p of output m*block + b: interleave
    y = y.reshape(x.shape[:-1] + (m, l, block)).transpose(-1, -2)
    y = y.reshape(x.shape[:-1] + (-1,))
    return y[..., :n * l].to(_out_dtype(x.dtype, taps.dtype))


# ----------------------------------------------------------------- multi-filt
def fir_filterbank(x: torch.Tensor, tapbank,
                   precision: str = "f32") -> torch.Tensor:
    """Apply F different filters of equal length to the same input.

    tapbank: (F, K), convolution orientation.  Returns (F, n) with
    n = len(x) - K + 1: one matmul with F*B output columns (band-edge FLL,
    interpolator banks, pfb clock sync)."""
    tapbank = torch.flip(as_taps(tapbank, x.device), dims=(1,))
    f, k = tapbank.shape
    n = x.shape[0] - (k - 1)
    block = _block_for(n)
    m = -(-n // block)
    need = m * block + k - 1
    xp = pad_last(x, 0, max(0, need - x.shape[0]))
    w = _window_matrix(xp, k, block)
    t = torch.cat([_tap_matrix(tapbank[i], block) for i in range(f)], dim=1)
    y = _matmul(w, t, precision).reshape(m, f, block)
    y = y.transpose(0, 1).reshape(f, m * block)
    return y[:, :n].to(_out_dtype(x.dtype, tapbank.dtype))


# -------------------------------------------------------------------- rotator
def _phase_on(phase, device) -> torch.Tensor:
    """A carried phase (tensor or host number) as float32 on ``device``; a
    host number is filled in on the device, with no host-to-device copy, so
    the call stays inside a CUDA-graph capture."""
    if isinstance(phase, torch.Tensor):
        return phase.to(device=device, dtype=torch.float32)
    return torch.full((), float(phase), dtype=torch.float32, device=device)


def phase_ramp(phase, step: float, n: int, device) -> torch.Tensor:
    """float32 ``phase + step * arange(n)``, rounded as grtpu's compiled
    step rounds it: the integer ramp is widened to float32 and multiplied by
    the step rounded to float32, and the product is added to the carried
    phase in one fused multiply-add (one rounding), which is what XLA emits
    for this expression inside a jitted flowgraph.  The fused operation is
    taken in float64, where the product of two float32 values is exact.  A
    long ramp reaches 1e4 rad and more, where one float32 step is 1e-3 rad,
    so the order of rounding is what the two packages' agreement rests on."""
    k = torch.arange(n, dtype=torch.int32, device=device).to(torch.float64)
    ph = _phase_on(phase, device)
    step32 = torch.tensor(float(step), dtype=torch.float32).item()
    return (ph.to(torch.float64) + step32 * k).to(torch.float32)


def phase_advance(phase, total: float, device) -> torch.Tensor:
    """float32 ``(phase + total) mod 2 pi`` (floored), the carried phase
    after a chunk; ``total`` is the host float ``step * n``."""
    ph = _phase_on(phase, device)
    return torch.remainder(ph + float(total), 2 * np.pi)


def freq_xlating_fir_filter(x: torch.Tensor, taps, phase, phase_inc: float,
                            decim: int = 1, precision: str = "f32"):
    """Frequency-translating decimating FIR
    (gr_freq_xlating_fir_filter_XXX.cc.t:72-123 semantics).

    The reference pre-rotates the taps by the center frequency and spins the
    *output* by a rotator advancing ``decim * phase_inc`` per output sample.
    Here ``taps`` must already be the rotated (complex) taps
    (:func:`rotate_taps`); ``phase`` is the carried rotator phase (radians);
    ``phase_inc`` is radians per *input* sample (= -2*pi*center_freq/fs as
    in the reference).

    Returns (y, new_phase)."""
    y = fir_filter(x, taps, decim, precision)
    nout = y.shape[0]
    ph = phase_ramp(phase, phase_inc * decim, nout, x.device)
    rot = torch.complex(torch.cos(ph), torch.sin(ph))
    new_phase = phase_advance(phase, phase_inc * decim * nout, x.device)
    return (y * rot).to(torch.complex64), new_phase


def rotate_taps(taps, center_freq: float, fs: float) -> np.ndarray:
    """Pre-rotate real prototype taps to a center frequency
    (gr_freq_xlating_fir_filter ctor behavior)."""
    k = np.arange(len(taps))
    shift = np.exp(2j * np.pi * center_freq / fs * k)
    return (np.asarray(taps) * shift).astype(np.complex64)


# ---------------------------------------------------------------- composition
def compose_taps(*tap_sets) -> np.ndarray:
    """Compose cascaded LTI FIR filters into one equivalent filter.

    Chaining FIRs is convolution of their impulse responses:
    ``fir(fir(x, a), b) == fir(x, compose_taps(a, b))`` exactly (in exact
    arithmetic).  Accumulates in float64, returns float32 (complex64 for
    complex taps)."""
    out = np.asarray(tap_sets[0], np.float64)
    if np.iscomplexobj(tap_sets[0]):
        out = np.asarray(tap_sets[0], np.complex128)
    for t in tap_sets[1:]:
        out = np.convolve(out, np.asarray(t))
    if np.iscomplexobj(out):
        return out.astype(np.complex64)
    return out.astype(np.float32)


def compose_taps_power(taps, nstages: int) -> np.ndarray:
    """compose_taps of the same filter ``nstages`` times."""
    return compose_taps(*([taps] * nstages))
