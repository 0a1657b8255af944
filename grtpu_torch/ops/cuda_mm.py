"""Hopper kernel for the exact M&M clock recovery.

``mm_fwd`` (``csrc/mm_clock.cu``) replaces no Pallas kernel: grtpu runs the
variable-rate Mueller & Muller loop as a ``lax.scan``
(``grtpu.digital.loops``), which the port ran as a Python loop of ~61
small device operations a symbol.  One launch walks the whole call: the
samples and the interpolator bank staged in shared memory, one thread
carrying mu, omega, base and the last sample in registers, every
operation the plain loop's float32 (float64 in the dot) operation in its
order, so that the outputs and the state equal the plain loop's bit for
bit.  See the source's note for the design.

Its plain twin is ``grtpu_torch.digital.loops._mm_exact``, which
``clock_recovery_mm_ff`` and ``clock_recovery_mm_cc`` run on a CPU tensor;
they route a CUDA tensor here.  This wrapper launches the kernel or raises:
there is no fallback.  Each launch is counted in
``grtpu_torch.ops.cuda_fir.launches`` under ``mm_fwd`` (in the open record
of a CUDA-graph capture, if any).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grtpu_torch.ops.cuda_fir import _raw_stream, count_launch
from grtpu_torch.ops.mmse_interp import NSTEPS, NTAPS, bank_on

SMEM_OPTIN = 232448      # bytes of shared memory a block may take on Hopper
_STATIC = 256            # bytes csrc/mm_clock.cu keeps for its own variables
_HIST = (512 + 1) * 8    # floats of its record of the symbols walked
MIN_SAMPLES = NTAPS // 2  # below, the plain loop's window leaves the stream


def max_tile(cplx: bool) -> int:
    """Samples the kernel stages in shared memory at once, at most: what
    is left beside the 129 x 8 float32 bank and the record of the symbols
    walked since the last check (``mm_clock.cu`` checks the same sum)."""
    return ((SMEM_OPTIN - _STATIC - 4 * ((NSTEPS + 1) * NTAPS + _HIST))
            // (8 if cplx else 4))


def max_out_for(n_in: int, omega_nominal: float,
                omega_relative_limit: float) -> int:
    """The symbol slots of a call on ``n_in`` samples (``_mm_exact``'s)."""
    return int(np.ceil(n_in / max(omega_nominal * (1 - omega_relative_limit),
                                  1.0)))


def _library():
    from grtpu_torch.ops._build import library

    return library()


def mm_fwd(x: torch.Tensor, mu: torch.Tensor, omega: torch.Tensor,
           base: torch.Tensor, last: torch.Tensor, omega_nominal: float,
           gain_omega: float, gain_mu: float, omega_relative_limit: float,
           cc: bool):
    """One launch of ``mm_fwd`` over ``x`` (n_in,) float32 (``cc`` False,
    ``clock_recovery_mm_ff``) or complex64 (``cc`` True,
    ``clock_recovery_mm_cc``: the error clipped to [-1, 1]) on the card,
    from the state ``mu``, ``omega``, ``base`` (one float32 each) and
    ``last`` (one sample of x's type).  Returns ``(ys, n_valid, mu, omega,
    base, last)`` as ``_mm_exact`` does: ``max_out`` slots, a 0-d int32
    count of the valid prefix and the 0-d state after the call, all on the
    card, with no host read.  Raises on a type, shape or device the kernel
    does not take, and on 1 to 3 samples, where the plain loop's window
    indices leave the stream."""
    if x.dtype not in (torch.float32, torch.complex64):
        raise TypeError(f"mm_fwd takes float32 or complex64 samples, not "
                        f"{x.dtype}")
    if x.ndim != 1:
        raise ValueError(f"mm_fwd takes one stream (n_in,), not {tuple(x.shape)}")
    if x.is_complex() != cc:
        raise TypeError(f"clock_recovery_mm_{'cc' if cc else 'ff'} on the card "
                        f"takes {'complex64' if cc else 'float32'} samples, "
                        f"not {x.dtype}")
    for name, t, dt in (("mu", mu, torch.float32), ("omega", omega, torch.float32),
                        ("base", base, torch.float32), ("last", last, x.dtype)):
        if t.dtype != dt or t.numel() != 1:
            raise TypeError(f"mm_fwd takes {name} as one {dt}, not "
                            f"{tuple(t.shape)} {t.dtype}")
    n_in = x.shape[0]
    if 0 < n_in < MIN_SAMPLES:
        raise ValueError(f"mm_fwd takes {MIN_SAMPLES} samples or more, not "
                         f"{n_in}: the window of {NTAPS} leaves the stream")
    if x.device.type != "cuda":
        raise ValueError(f"mm_fwd runs on a CUDA tensor, not {x.device}")
    if n_in == 0:
        return (x.new_zeros((0,)),
                torch.zeros((), dtype=torch.int32, device=x.device),
                mu, omega, base, last)
    state = [t if t.device == x.device else t.to(x.device)
             for t in (mu, omega, base, last)]
    max_out = max_out_for(n_in, omega_nominal, omega_relative_limit)
    om_lim = omega_nominal * omega_relative_limit
    lo, hi = omega_nominal - om_lim, omega_nominal + om_lim
    x = x.contiguous()
    dev = x.device
    ys = torch.empty((max_out,), dtype=x.dtype, device=dev)
    n_valid = torch.empty((), dtype=torch.int32, device=dev)
    out = [torch.empty((), dtype=t.dtype, device=dev) for t in state]
    bank = bank_on(dev)
    tile = min(n_in, max_tile(cc))
    lib = _library()
    f = ctypes.c_float
    args = (x.data_ptr(), n_in, *(t.data_ptr() for t in state),
            bank.data_ptr(), f(gain_omega), f(gain_mu), f(lo), f(hi), max_out,
            int(cc), tile, ys.data_ptr(), n_valid.data_ptr(),
            *(t.data_ptr() for t in out))
    index = dev.index
    if index == torch._C._cuda_getDevice():
        err = lib.mm_fwd(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = lib.mm_fwd(*args, _raw_stream(index))
    if err:
        raise RuntimeError("mm_fwd launch failed: "
                           + lib.mm_error_string(err).decode())
    count_launch("mm_fwd")
    return (ys, n_valid, *out)
