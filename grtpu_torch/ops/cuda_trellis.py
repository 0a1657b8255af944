"""Hopper kernels for the two long recursions of the trellis and ATSC slice.

Neither replaces a Pallas kernel: grtpu runs both as ``lax.scan``, which the
port would otherwise run as a Python loop of small torch ops, one launch
each, millions a field.

* ``viterbi_fwd`` (``csrc/trellis_viterbi.cu``): the table-driven Viterbi
  decoder of ``grtpu.trellis.algorithms.viterbi`` (forward scan ``:89``,
  traceback ``:113``) over a batch of rows, one CUDA block a row and one
  thread a state.  :func:`viterbi_ref` is its plain twin, the same step loop
  vectorized over the rows; the two agree exactly (every step is one float32
  add, compare or subtract, in the same order).
* ``dfe_feedback_fwd`` (``csrc/atsc_dfe.cu``): the feedback recursion of the
  decision-feedback equalizer, ``grtpu.models.atsc_rf._dfe_filter``'s scan
  (``:596``), one warp.  :func:`dfe_feedback_ref` is its plain twin; the
  kernel sums the 192-term dot in another order than ``torch.dot``, so the
  two are held to equal decisions and outputs within 1e-4.

Dispatch is by the tensor's device: a CPU tensor runs the twin, a CUDA
tensor launches the kernel (building it at first use) or raises.  Each
launch is counted in ``grtpu_torch.ops.cuda_fir.launches`` under the
kernel's name (in the open record of a CUDA-graph capture, if any).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grtpu_torch.ops.cuda_fir import _raw_stream, count_launch

NEG = -1e9
MAX_STATES = 1024        # one thread a state in one block
_SMEM = 48 * 1024        # a block's shared memory without an opt-in


class TrellisTables(NamedTuple):
    """An FSM's predecessor tables on one device: ``ps``, ``pi`` (S, deg)
    int32 with -1 for a missing edge, ``eo`` (S, deg) int32, the output
    symbol of each edge (``OS[max(PS, 0), max(PI, 0)]``), and ``O``, the
    number of output symbols (the metrics' last axis)."""
    ps: torch.Tensor
    pi: torch.Tensor
    eo: torch.Tensor
    O: int


def tables(fsm, device) -> TrellisTables:
    """``fsm``'s predecessor tables on ``device``, made once per device and
    kept on the FSM (a captured step then copies nothing to the card)."""
    cache = fsm.__dict__.setdefault("_torch_tables", {})
    key = torch.device(device)
    if key not in cache:
        ps = np.asarray(fsm.PS, np.int32)
        pi = np.asarray(fsm.PI, np.int32)
        eo = np.asarray(fsm.OS)[np.maximum(ps, 0), np.maximum(pi, 0)]
        cache[key] = TrellisTables(*(
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(key)
            for a in (ps, pi, eo)), int(fsm.O))
    return cache[key]


# ------------------------------------------------------------- plain twins
def viterbi_ref(metrics: torch.Tensor, tab: TrellisTables,
                start_state: int = 0, end_state: int = -1) -> torch.Tensor:
    """Plain PyTorch twin of ``viterbi_fwd``: metrics (B, T, O) float32 ->
    (B, T) int32 decoded inputs.  The step of grtpu's scan, vectorized over
    the rows: ``cand = where(valid, pm[PS] + m_t[EO], NEG)``, the first arg
    max of each state's candidates, ``pm = max - max(max)``; then the
    traceback from ``end_state`` or the first arg max of the final
    metrics."""
    b, t_len, _ = metrics.shape
    ps, pi, eo = tab.ps.long(), tab.pi.long(), tab.eo.long()
    s_count = ps.shape[0]
    valid = ps >= 0
    psc, pic = ps.clamp(min=0), pi.clamp(min=0)
    dev = metrics.device
    pm = torch.full((b, s_count), NEG, dtype=torch.float32, device=dev)
    if start_state >= 0:
        pm[:, start_state] = 0.0
    else:
        pm.zero_()
    edge_m = metrics[:, :, eo]                       # (B, T, S, deg)
    choices = torch.empty((b, t_len, s_count), dtype=torch.long, device=dev)
    for t in range(t_len):
        cand = torch.where(valid, pm[:, psc] + edge_m[:, t], NEG)
        choices[:, t] = cand.argmax(-1)
        best = cand.amax(-1)
        pm = best - best.amax(-1, keepdim=True)
    if end_state >= 0:
        s = torch.full((b,), end_state, dtype=torch.long, device=dev)
    else:
        s = pm.argmax(-1)
    out = torch.empty((b, t_len), dtype=torch.int32, device=dev)
    for t in range(t_len - 1, -1, -1):
        j = choices[:, t].gather(1, s[:, None])[:, 0]
        out[:, t] = pic[s, j]
        s = psc[s, j]
    return out


def slice8(y: torch.Tensor) -> torch.Tensor:
    """Nearest 8-VSB level in {-7, -5, ..., +7} (round half to even, as
    ``jnp.round``)."""
    return 2.0 * torch.clamp(torch.round((y + 7.0) / 2.0), 0.0, 7.0) - 7.0


def dfe_feedback_ref(ff: torch.Tensor, wfb: torch.Tensor,
                     ring: torch.Tensor):
    """Plain PyTorch twin of ``dfe_feedback_fwd``: ``y[k] = ff[k] -
    dot(wfb, ring)``, ``ring <- [slice8(y[k]), ring[:-1]]`` (ring newest
    first).  The decisions are written backwards into one buffer, so the
    ring of step k is a view of it.  Returns (y (n,), the final ring)."""
    n = ff.shape[0]
    nfb = wfb.shape[0]
    hist = torch.cat([ff.new_zeros(n), ring.to(torch.float32)])
    y = torch.empty_like(ff)
    for k in range(n):
        yk = ff[k] - torch.dot(wfb, hist[n - k:n - k + nfb])
        y[k] = yk
        hist[n - k - 1] = slice8(yk)
    return y, hist[:nfb].clone()


# ----------------------------------------------------------------- kernels
def _library():
    from grtpu_torch.ops._build import library

    return library()


def _launch(x: torch.Tensor, name: str, fn, args, err_string):
    index = x.device.index
    if index == torch._C._cuda_getDevice():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           + err_string(err).decode())
    count_launch(name)


def viterbi_tile_steps(s_count: int, deg: int, t_len: int) -> int:
    """Steps of the traceback tile that keep a block's shared memory within
    48 KB (path metrics, tables and the tile of int8 decisions)."""
    fixed = (2 * s_count + 32 + 3 * s_count * deg + 1) * 4
    return max(0, min(t_len, (_SMEM - fixed) // s_count))


def _viterbi_launch(metrics, tab, start_state, end_state):
    b, t_len, o = metrics.shape
    s_count, deg = tab.ps.shape
    out = torch.empty((b, t_len), dtype=torch.int32, device=metrics.device)
    if b == 0 or t_len == 0:
        return out
    tile = viterbi_tile_steps(s_count, deg, t_len)
    if s_count > MAX_STATES or deg > 127 or tile < 1:
        raise ValueError(f"viterbi_fwd takes at most {MAX_STATES} states and "
                         f"tables that fit 48 KB of shared memory (S="
                         f"{s_count}, in-degree {deg})")
    choices = torch.empty((b, t_len, s_count), dtype=torch.int8,
                          device=metrics.device)
    lib = _library()
    _launch(metrics, "viterbi_fwd", lib.viterbi_fwd,
            (metrics.data_ptr(), tab.ps.data_ptr(), tab.pi.data_ptr(),
             tab.eo.data_ptr(), b, t_len, o, s_count, deg, int(start_state),
             int(end_state), tile, choices.data_ptr(), out.data_ptr()),
            lib.trellis_error_string)
    return out


def viterbi_fwd(metrics: torch.Tensor, tab: TrellisTables,
                start_state: int = 0, end_state: int = -1) -> torch.Tensor:
    """Viterbi over each row of ``metrics`` (B, T, O) float32: the kernel on
    a CUDA tensor, :func:`viterbi_ref` on a CPU one.  Returns (B, T)
    int32."""
    if (metrics.dtype != torch.float32 or metrics.ndim != 3
            or metrics.shape[2] != tab.O):
        raise TypeError(f"expected (B, T, {tab.O}) float32 metrics, got "
                        f"{tuple(metrics.shape)} {metrics.dtype}")
    s_count = tab.ps.shape[0]
    if not (start_state < s_count and end_state < s_count):
        raise ValueError(f"start/end state outside the FSM's {s_count} "
                         f"states: {start_state}, {end_state}")
    if metrics.device.type == "cpu":
        return viterbi_ref(metrics, tab, start_state, end_state)
    if metrics.device.type != "cuda":
        raise ValueError(f"no Viterbi kernel for device {metrics.device}")
    if tab.ps.device != metrics.device:
        raise ValueError("the FSM tables lie on another device than the "
                         "metrics")
    return _viterbi_launch(metrics.contiguous(), tab, start_state, end_state)


def dfe_feedback(ff: torch.Tensor, wfb: torch.Tensor, ring: torch.Tensor):
    """The DFE feedback recursion over ``ff`` (n,) float32 with taps ``wfb``
    (nfb,) and the carried ring (nfb,): the kernel on CUDA tensors,
    :func:`dfe_feedback_ref` on CPU ones.  Returns (y, the final ring)."""
    for name, v in (("ff", ff), ("wfb", wfb), ("ring", ring)):
        if v.dtype != torch.float32 or v.ndim != 1:
            raise TypeError(f"{name}: expected a 1-d float32 tensor")
    nfb = wfb.shape[0]
    if ring.shape[0] != nfb:
        raise ValueError("the ring and the feedback taps differ in length")
    if not ff.device == wfb.device == ring.device:
        raise ValueError("ff, wfb and ring lie on different devices")
    if ff.device.type == "cpu":
        return dfe_feedback_ref(ff, wfb, ring)
    if ff.device.type != "cuda":
        raise ValueError(f"no DFE kernel for device {ff.device}")
    if nfb % 32 or not 32 <= nfb <= 256:
        raise ValueError(f"dfe_feedback_fwd takes 32 to 256 feedback taps in "
                         f"steps of 32, got {nfb}")
    ff, wfb, ring = ff.contiguous(), wfb.contiguous(), ring.contiguous()
    y = torch.empty_like(ff)
    ring_out = torch.empty_like(ring)
    if ff.shape[0] == 0:
        return y, ring.clone()
    lib = _library()
    _launch(ff, "dfe_feedback_fwd", lib.dfe_feedback_fwd,
            (ff.data_ptr(), wfb.data_ptr(), ring.data_ptr(), ff.shape[0], nfb,
             y.data_ptr(), ring_out.data_ptr()), lib.dfe_error_string)
    return y, ring_out
