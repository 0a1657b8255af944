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

import math
from fractions import Fraction

import numpy as np
import torch

from grtpu_torch.utils.trace import span

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
TWO_PI = 2 * math.pi


def _phase_on(phase, device) -> torch.Tensor:
    """A carried phase (tensor or host number) as float64 on ``device``; a
    host number is filled in on the device, with no host-to-device copy, so
    the call stays inside a CUDA-graph capture."""
    if isinstance(phase, torch.Tensor):
        return phase.to(device=device, dtype=torch.float64)
    return torch.full((), float(phase), dtype=torch.float64, device=device)


def _wrap_step(step, n: int = 1) -> float:
    """``step * n`` mod 2 pi, in [0, 2 pi), worked out on the host.  A
    ``fractions.Fraction`` step is a rational number of cycles a sample and
    is reduced exactly (one rounding, of the reduced phase); a float step is
    radians a sample, multiplied in float64 and reduced by an exact
    ``fmod``."""
    if isinstance(step, Fraction):
        return float((step * n) % 1) * TWO_PI
    r = math.fmod(float(step) * n, TWO_PI)
    return r + TWO_PI if r < 0 else r


def phase_ramp(phase, step, n: int, device) -> torch.Tensor:
    """float32 ``(phase + step * k) mod 2 pi`` for k in [0, n): the phases
    of a rotator or NCO over one chunk.  The step is reduced mod 2 pi on the
    host (:func:`_wrap_step`), the ramp formed in float64 and reduced mod 2 pi
    before the one rounding to float32, so every phase is good to float32's
    rounding of a number below 2 pi (2.4e-7 rad) however long the ramp.
    (grtpu forms the ramp in float32 before reducing it: at 6.4e5 rad one
    float32 step there is 0.0625 rad.)  No host read: it stays valid inside
    a CUDA-graph capture."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    ph = _phase_on(phase, device) + _wrap_step(step) * k
    return torch.remainder(ph, TWO_PI).to(torch.float32)


def phase_advance(phase, step, n: int, device) -> torch.Tensor:
    """The carried phase after ``n`` samples of ``step``: float64
    ``(phase + (step * n mod 2 pi)) mod 2 pi``, the product reduced on the
    host first (:func:`_wrap_step`), so the phase stays in [0, 2 pi) and
    does not drift from chunk to chunk (a rational ``Fraction`` step of
    cycles stays exact to float64 rounding over any number of chunks)."""
    return torch.remainder(_phase_on(phase, device) + _wrap_step(step, n),
                           TWO_PI)


def position_ramp(start: float, step: float, n: int, device) -> torch.Tensor:
    """float32 ``start + step * k`` for k in [0, n): sample positions, not
    phases, so nothing is reduced.  Rounded as grtpu's compiled step rounds
    it: the integer ramp widened to float32 times the step rounded to
    float32, added to the float32 start in one fused multiply-add (taken in
    float64, where the product of two float32 values is exact)."""
    k = torch.arange(n, dtype=torch.int32, device=device).to(torch.float64)
    start32, step32 = float(np.float32(start)), float(np.float32(step))
    return (start32 + step32 * k).to(torch.float32)


def freq_xlating_fir_filter(x: torch.Tensor, taps, phase, phase_inc,
                            decim: int = 1, precision: str = "f32",
                            fir=None):
    """Frequency-translating decimating FIR
    (gr_freq_xlating_fir_filter_XXX.cc.t:72-123 semantics).

    The reference pre-rotates the taps by the center frequency and spins the
    *output* by a rotator advancing ``decim * phase_inc`` per output sample.
    Here ``taps`` must already be the rotated (complex) taps
    (:func:`rotate_taps`); ``phase`` is the carried rotator phase (radians);
    ``phase_inc`` is radians per *input* sample (= -2*pi*center_freq/fs as
    in the reference), or a ``fractions.Fraction`` of cycles per input
    sample (-center_freq/fs), which the rotator follows exactly.  The
    phases are reduced mod 2 pi before they are rounded to float32
    (:func:`phase_ramp`), as ``gr_rotator`` keeps its phasor to float32's
    rounding at every output.

    ``fir``: the filter, ``fir(x, taps, decim)``; by default
    :func:`fir_filter` at ``precision``.

    Returns (y, new_phase), the phase float64 in [0, 2 pi)."""
    with span("grtpu.xlate.fir"):
        y = (fir_filter(x, taps, decim, precision) if fir is None
             else fir(x, taps, decim))
    with span("grtpu.xlate.rotate"):
        nout = y.shape[0]
        ph = phase_ramp(phase, phase_inc * decim, nout, x.device)
        rot = torch.complex(torch.cos(ph), torch.sin(ph))
        new_phase = phase_advance(phase, phase_inc * decim, nout, x.device)
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
