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
