"""Hopper kernels for the two long recursions of the trellis and ATSC slice.

Neither replaces a Pallas kernel: grtpu runs both as ``lax.scan``, which the
port would otherwise run as a Python loop of small torch ops, one launch
each, millions a field.  Both are bound by their chains of dependent steps,
not by bytes or operations, and are designed for the latency of one step.

* ``viterbi_fwd`` (``csrc/trellis_viterbi.cu``): the table-driven Viterbi
  decoder of ``grtpu.trellis.algorithms.viterbi`` (forward scan ``:89``,
  traceback ``:113``) over a batch of rows.  :func:`viterbi_route` picks one
  of two routes by the FSM's shape.  The warp route (up to 32 states,
  in-degree 8, no missing edge) gives each state a lane and packs 32 / S'
  rows into a warp (S' the power of two >= S): the predecessors' metrics
  come by shuffle, the row's max by shuffles over the row's own lanes, the
  metrics are staged into shared memory a tile ahead, and the decisions
  leave as ballot words, 32 steps in one store; the traceback walks them
  back, one shuffle a step.  The block route (up to 1024 states) runs one
  block a row and one thread a state, its metrics staged the same way.  :func:`viterbi_ref` is the plain
  twin, the same step loop vectorized over the rows; both routes agree with
  it exactly (every step is one float32 add, compare or subtract, in the
  same order).
* ``dfe_feedback_fwd`` (``csrc/atsc_dfe.cu``): the feedback recursion of the
  decision-feedback equalizer, ``grtpu.models.atsc_rf._dfe_filter``'s scan
  (``:596``), one warp.  The dot over the ring is transposed: the warp keeps
  the partial sums of the next nfb outputs and adds each new decision into
  all of them, and every lane forms each decision itself, so a step's chain
  is one multiply-add, a subtract and the slicer.  :func:`dfe_feedback_ref` is its plain twin; the kernel sums in
  time order (the ring's terms first), not in ``torch.dot``'s, so the two
  are held to equal decisions and outputs within 1e-4.

Dispatch is by the tensor's device: a CPU tensor runs the twin, a CUDA
tensor launches the kernel (building it at first use) or raises.  Each
launch is counted in ``grtpu_torch.ops.cuda_fir.launches`` under the
kernel's name (in the open record of a CUDA-graph capture, if any).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from grtpu_torch.ops.cuda_fir import (_H100_SMS, _raw_stream, _sm_count,
                                      count_launch)

NEG = -1e9
MAX_STATES = 1024        # block route: one thread a state in one block
WARP_MAX_STATES = 32     # warp route: one lane a state
WARP_MAX_DEG = 8         # warp route: a lane's tables in 4 * 8 registers
_WARP_TILE = 32          # warp route: steps of a metric tile
_WARPS = 4               # warp route: most warps a block
_BLOCK_STEPS = 32        # block route: most steps of a metric tile
_SMEM = 48 * 1024        # a block's shared memory without an opt-in


class TrellisTables(NamedTuple):
    """An FSM's predecessor tables on one device: ``ps``, ``pi`` (S, deg)
    int32 with -1 for a missing edge, ``eo`` (S, deg) int32, the output
    symbol of each edge (``OS[max(PS, 0), max(PI, 0)]``), ``O``, the
    number of output symbols (the metrics' last axis), and ``complete``:
    no edge is missing (only then may a call take the warp route, so it is
    given, never assumed)."""
    ps: torch.Tensor
    pi: torch.Tensor
    eo: torch.Tensor
    O: int
    complete: bool


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
            for a in (ps, pi, eo)), int(fsm.O), bool((ps >= 0).all()))
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


def _rows_per_warp(s_count: int) -> int:
    """Rows a warp decodes on the warp route: 32 / S', S' the power of two
    >= S."""
    return 32 >> (s_count - 1).bit_length()


def _warp_bytes(s_count: int, o: int) -> int:
    """Shared memory of one warp on the warp route (trellis_viterbi.cu's
    ``viterbi_smem``): a 32-step metric tile of its rows, each output
    symbol's run of steps padded to 33 floats (so that a step's reads fall
    in distinct banks), double-buffered."""
    return 2 * _rows_per_warp(s_count) * (_WARP_TILE + 1) * o * 4


def viterbi_route(s_count: int, deg: int, o: int,
                  complete: bool = True) -> str:
    """The route ``viterbi_fwd`` takes for an FSM of ``s_count`` states,
    in-degree ``deg`` and ``o`` output symbols: ``"warp"`` where a state
    fits a lane (S <= 32), its tables the lane's registers (deg <= 8), a
    warp's metric tile 48 KB of shared memory and no edge is missing (a
    missing edge's NEG would cost every step of the chain a select);
    ``"block"`` otherwise."""
    if (s_count <= WARP_MAX_STATES and deg <= WARP_MAX_DEG and complete
            and _warp_bytes(s_count, o) <= _SMEM):
        return "warp"
    return "block"


class ViterbiPlan(NamedTuple):
    """How one ``viterbi_fwd`` call launches: its ``route``; ``warps`` a
    block (warp route: one while the card has an SM for each warp, else up
    to four); ``steps`` of a metric tile and ``tb_steps`` of a
    traceback tile (block route); ``smem``, a block's bytes of shared
    memory, within 48 KB on both routes; ``scratch``, the bytes of the
    decisions (warp route: ceil(log2 deg) 32-bit ballot words a warp and
    step; block route: one int8 a row, step and state)."""
    route: str
    warps: int
    steps: int
    tb_steps: int
    smem: int
    scratch: int


@functools.lru_cache(maxsize=256)
def viterbi_plan(s_count: int, deg: int, o: int, b: int, t_len: int,
                 route=None, complete: bool = True,
                 sms: int = _H100_SMS) -> ViterbiPlan:
    """The launch of a (b, t_len, o) call on ``route`` (by default
    :func:`viterbi_route`'s), on a card of ``sms`` SMs."""
    auto = viterbi_route(s_count, deg, o, complete)
    route = route or auto
    if route == "warp":
        if auto != "warp":
            raise ValueError(f"the warp route takes at most {WARP_MAX_STATES}"
                             f" states, in-degree {WARP_MAX_DEG}, a tile "
                             f"within 48 KB and no missing edge (S={s_count},"
                             f" in-degree {deg}, O={o}, complete={complete})")
        per_warp = _warp_bytes(s_count, o)
        n_warps = -(-b // _rows_per_warp(s_count))
        warps = min(_WARPS, -(-n_warps // sms), _SMEM // per_warp)
        words = max(1, (1 << (deg - 1).bit_length()).bit_length() - 1)
        return ViterbiPlan("warp", warps, _WARP_TILE, 0, warps * per_warp,
                           n_warps * t_len * words * 4)
    if route != "block":
        raise ValueError(f"no Viterbi route {route!r}")
    fixed = (2 * s_count + 32 + 3 * s_count * deg + 1) * 4
    avail = _SMEM - fixed - 16
    steps = min(_BLOCK_STEPS, t_len, avail // (8 * o))
    tb_steps = min(t_len, avail // s_count)
    if s_count > MAX_STATES or deg > 127 or steps < 1 or tb_steps < 1:
        raise ValueError(f"viterbi_fwd takes at most {MAX_STATES} states and "
                         f"tables that fit 48 KB of shared memory (S="
                         f"{s_count}, in-degree {deg}, O={o})")
    region = -(-max(8 * o * steps, tb_steps * s_count) // 16) * 16
    return ViterbiPlan("block", 1, steps, tb_steps, region + fixed,
                       b * t_len * s_count)


def _viterbi_launch(metrics, tab, start_state, end_state, route):
    b, t_len, o = metrics.shape
    s_count, deg = tab.ps.shape
    out = torch.empty((b, t_len), dtype=torch.int32, device=metrics.device)
    if b == 0 or t_len == 0:
        return out
    plan = viterbi_plan(s_count, deg, o, b, t_len, route, tab.complete,
                        _sm_count(metrics.device.index))
    code = 1 if plan.route == "warp" else 0
    lib = _library()
    scratch = torch.empty(plan.scratch, dtype=torch.uint8,
                          device=metrics.device)
    _launch(metrics, "viterbi_fwd", lib.viterbi_fwd,
            (metrics.data_ptr(), tab.ps.data_ptr(), tab.pi.data_ptr(),
             tab.eo.data_ptr(), b, t_len, o, s_count, deg, int(start_state),
             int(end_state), code, plan.steps, plan.tb_steps, plan.warps,
             scratch.data_ptr(), out.data_ptr()),
            lib.trellis_error_string)
    return out


def viterbi_fwd(metrics: torch.Tensor, tab: TrellisTables,
                start_state: int = 0, end_state: int = -1,
                _route=None) -> torch.Tensor:
    """Viterbi over each row of ``metrics`` (B, T, O) float32: the kernel on
    a CUDA tensor, :func:`viterbi_ref` on a CPU one.  Returns (B, T)
    int32.  ``_route`` forces ``"warp"`` or ``"block"`` on the card, for
    holding and timing both routes side by side."""
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
    return _viterbi_launch(metrics.contiguous(), tab, start_state, end_state,
                           _route)


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
