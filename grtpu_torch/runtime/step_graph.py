"""A loop step over static buffers, replayed from one CUDA graph.

grtpu runs its long recursions (the chunked FPLL, the segment-batched bit
timing loop, the equalizers' training sweeps) and its executor's chunk step
as jitted ``lax.scan`` bodies.  Their torch form is a Python loop whose
every step launches tens to hundreds of small kernels; on the card the
host's cost of those launches is the whole time.  :class:`StepGraph` is the
torch form of the jitted body: ``step()`` reads and writes only tensors
that live as long as the object (the carried state, the whole input, the
whole output, a step counter kept on the device), so on a CUDA device its
second call is captured into a ``torch.cuda.CUDAGraph`` and every later
call replays it.  Its first call runs eagerly and fills every cached
constant.  On a CPU device each call runs the step.  Hand-kernel launches
made inside the capture are recorded with the graph and counted at each
replay (``grtpu_torch.ops.cuda_fir.launches``).  The executor's
``run(device_loop=True)`` keeps one for each piece of its step
(``runtime/device_loop.py``).
"""

from __future__ import annotations

import gc
import time

import torch


class StepGraph:
    """Call ``step()`` on ``device``: eagerly once, then (on CUDA) from a
    CUDA graph captured at the second call.  ``step`` takes no arguments
    and returns nothing: it works in place on its static buffers."""

    def __init__(self, step, device):
        self.step = step
        self.cuda = torch.device(device).type == "cuda"
        self.calls = 0
        self.graph = None
        self.record = None
        self.capture_seconds = 0.0

    def __call__(self):
        if not self.cuda or self.calls == 0:
            self.step()
            self.calls += 1
            return
        if self.graph is None:
            self.capture()
        self.graph.replay()
        from grtpu_torch.ops.cuda_fir import add_launches

        add_launches(self.record)
        self.calls += 1

    def capture(self):
        """Capture ``step()`` into the graph that later calls replay.  The
        call itself is not counted: the capture runs nothing."""
        from grtpu_torch.ops.cuda_fir import recording_launches

        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # A CUDA graph that the garbage collector frees during the capture
        # (an earlier executor's, kept by a reference cycle) releases its
        # memory with a call the capture cannot hold, and CUDA then
        # invalidates the capture without an error: collect first, and let
        # nothing be collected until the capture has ended.
        gc.collect()
        was_on = gc.isenabled()
        gc.disable()
        try:
            with recording_launches() as record:
                with torch.cuda.graph(graph):
                    self.step()
        finally:
            if was_on:
                gc.enable()
        self.graph, self.record = graph, record
        self.capture_seconds = time.perf_counter() - t0


# Steps a StepGraph replay runs in step_scan: the fastest of U = 16, 32
# and 64 on chip_smoke phase 12's G.721 bank (64 channels, NVIDIA H100).
UNROLL = 32
# What step_scan's graphs cost, summed over calls: read and zeroed by
# chip_smoke around a phase, as cuda_fir.launches is.
scan_stats = {"graphs": 0, "replays": 0, "capture_seconds": 0.0}


def capturing(device) -> bool:
    """True while a CUDA graph capture is running on ``device``'s stream."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _store(dst, vals):
    """Copy ``vals`` into the static buffers ``dst``; a value that shares
    memory with a destination is cloned before the first copy."""
    ptrs = {d.untyped_storage().data_ptr() for d in dst}
    staged = [v if v is d or v.untyped_storage().data_ptr() not in ptrs
              else v.clone() for d, v in zip(dst, vals)]
    for d, v in zip(dst, staged):
        if v is not d:
            d.copy_(v)


def step_scan(step, state, xs: torch.Tensor, out: torch.Tensor,
              unroll: int = None):
    """``lax.scan`` over axis 0 of ``xs``: ``state, out[t] = step(state,
    xs[t])`` for every t, in order; returns the final state (a tuple).

    ``step`` takes and returns a tuple of tensors and makes one output
    item a step; ``out`` is preallocated with ``xs.shape[0]`` rows.
    Outside a capture, each ``unroll`` steps (``UNROLL`` unless given) are
    one :class:`StepGraph` call over static buffers (the whole input and
    output, the state, a step counter on the device): on a CUDA device a
    replay, so the loop costs the host one replay per ``unroll`` steps; on
    the CPU the same buffers with each call run.  The last ``T % unroll``
    steps run one after the other.  Inside a capture (a block's ``apply``
    under ``run(device_loop=True)``) every step runs one after the other
    and the capture holds them all."""
    state = tuple(state)
    n = xs.shape[0]
    u = UNROLL if unroll is None else int(unroll)
    done = 0
    if not capturing(xs.device) and n >= 2 * u:
        st = [s.clone() for s in state]
        ctr = torch.zeros(1, dtype=torch.int64, device=xs.device)
        ar = torch.arange(u, device=xs.device)

        def graph_step():
            idx = ctr + ar
            xb = xs.index_select(0, idx)
            s = tuple(st)
            ys = []
            for k in range(u):
                s, y = step(s, xb[k])
                ys.append(y)
            out.index_copy_(0, idx, torch.stack(ys))
            _store(st, s)
            ctr.add_(u)

        graph = StepGraph(graph_step, xs.device)
        done = n // u * u
        for _ in range(n // u):
            graph()
        if graph.graph is not None:
            scan_stats["graphs"] += 1
            scan_stats["replays"] += n // u - 1
            scan_stats["capture_seconds"] += graph.capture_seconds
        state = tuple(st)
    if done < n:
        ys = []
        for t in range(done, n):
            state, y = step(state, xs[t])
            ys.append(y)
        out[done:] = torch.stack(ys)
    return state
