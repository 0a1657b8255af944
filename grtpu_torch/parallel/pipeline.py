"""Stage-pipelined streaming over the device mesh (pipeline parallelism).

Port of ``grtpu.parallel.pipeline``.  The analog of the reference's
thread-per-block scheduler (gr_scheduler_tpb.cc:53-78): there, every block
of a chain runs on its own OS thread and chunks flow downstream through
32 KiB double buffers (gr_flat_flowgraph.cc:96-100).  Here every stage of a
chain is the entry of a ``stage`` mesh axis, holding its parameters and
carried state on that entry's device, and each chunk is handed to the next
stage's device (a :func:`~grtpu_torch.parallel.mesh.ppermute` hop).  This
is the workload of the reference's mp-sched benchmark
(gnuradio-examples/python/mp-sched/synthetic.py:28-45): npipes parallel
pipelines of nstages 256-tap FIRs.

Semantics equal running the stages back to back on one device: each stage
carries its own history tail across chunks, so the pipelined output and
the carried state equal the sequential cascade's.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.parallel.mesh import (Mesh, axis_index, psum, tree_leaves,
                                       tree_map, tree_stack)


class PipelinedChain:
    """A chain of S structurally identical 1:1 stages, one a mesh entry.

    ``stage_fn(params, state, x) -> (state', y)`` with ``y.shape ==
    x.shape`` (rate-1 stages; rate changes belong inside a stage).
    ``params`` and ``state`` are trees of tensors whose leaves carry a
    leading stage axis of size S; stage s keeps its slice on the device of
    entry s of the ``stage`` axis (coordinate 0 on any other axis).

    :meth:`run` takes M + S - 1 pipeline steps: chunk j enters stage 0 at
    step j and leaves stage S-1 at step j + S - 1, and at each step every
    stage that holds a chunk runs ``stage_fn`` on it and hands its output
    to the next stage's device.  During fill (step t < s) and drain (t >= M
    + s) stage s holds filler: its work there is masked off (not run), so
    its carried state is the sequential cascade's.
    """

    def __init__(self, mesh: Mesh, stage_fn, params, state,
                 axis_name: str = "stage"):
        self.mesh = mesh
        self.axis_name = axis_name
        self.S = mesh.shape[axis_name]
        self.stage_fn = stage_fn
        leading = tree_leaves(params)[0].shape[0]
        if leading != self.S:
            raise ValueError(
                f"params leading axis {leading} != mesh '{axis_name}' size "
                f"{self.S}")
        ax = mesh.axis(axis_name)
        self.devices = [
            mesh.devices[tuple(s if a == ax else 0
                               for a in range(mesh.devices.ndim))]
            for s in range(self.S)]
        self.params = [tree_map(lambda leaf: leaf[s].to(d), params)
                       for s, d in enumerate(self.devices)]
        self._states = [tree_map(lambda leaf: leaf[s].to(d), state)
                        for s, d in enumerate(self.devices)]

    @property
    def state(self):
        """The carried state, stacked on the leading stage axis on the first
        stage's device."""
        return tree_stack(self._states, device=self.devices[0])

    def run(self, chunks: torch.Tensor) -> torch.Tensor:
        """Stream (M, chunk_size) chunks through the pipeline.

        Returns the (M, chunk_size) output of the final stage on the first
        stage's device; the carried state is updated, so consecutive runs
        stream seamlessly."""
        if not isinstance(chunks, torch.Tensor):
            chunks = torch.from_numpy(np.ascontiguousarray(chunks))
        M, S = chunks.shape[0], self.S
        slots = [None] * S
        outs = []
        for t in range(M + S - 1):
            sent = [None] * S
            for s, dev in enumerate(self.devices):
                if not s <= t < M + s:
                    continue
                x = chunks[t].to(dev) if s == 0 else slots[s]
                self._states[s], y = self.stage_fn(self.params[s],
                                                   self._states[s], x)
                if s + 1 < S:
                    sent[s + 1] = y.to(self.devices[s + 1])
                else:
                    outs.append(y.to(self.devices[0]))
            slots = sent
        return torch.stack(outs)


def fir_chain_pipeline(mesh: Mesh, taps: np.ndarray,
                       axis_name: str = "stage") -> PipelinedChain:
    """A pipeline of S decimation-1 FIR stages (taps: (S, K) float32), each
    carrying its K-1 history tail across chunks: the mp-sched synthetic
    workload with one mesh entry a stage instead of one thread a block."""
    from grtpu_torch.ops.fir import fir_filter

    taps = np.asarray(taps, np.float32)
    S, K = taps.shape

    def stage(params, state, x):
        if K == 1:  # memoryless stage: no history to carry
            return state, fir_filter(x, params, 1).to(x.dtype)
        xh = torch.cat([state, x])
        y = fir_filter(xh, params, 1)
        return xh[-(K - 1):], y.to(x.dtype)

    params = torch.from_numpy(taps)
    state = torch.zeros((S, max(K - 1, 1)), dtype=torch.float32)
    return PipelinedChain(mesh, stage, params, state, axis_name)


def tap_parallel_fir(x, taps_local: np.ndarray, mesh: Mesh, axis_name: str,
                     decim: int = 1) -> np.ndarray:
    """Tensor-parallel FIR: the tap axis split over a mesh axis.

    Each of the n shards holds a contiguous slice of the K taps and the
    full input window, computes its partial dot products, and a
    :func:`~grtpu_torch.parallel.mesh.psum` over ``axis_name`` adds them:
    one filter too long for one device split over several.

    ``x``: (N + K - 1,) with the full K-1 leading history, one copy a mesh
    entry (an object array) or one tensor copied to every entry.
    ``taps_local``: each entry's (K / n,) slice (entry i holds
    ``taps[i*Kl:(i+1)*Kl]``).  Returns the full (N // decim,) output, the
    same on every entry.

    Convention as ``grtpu_torch.ops.fir.fir_filter``: y[i] = sum_k taps[k]
    * x[i*decim + K - 1 - k]; shard i's k lie in [i*Kl, (i+1)*Kl), so its
    window of x starts at K - (i+1)*Kl."""
    from grtpu_torch.ops.fir import fir_filter

    n = mesh.shape[axis_name]
    partial = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.entries():
        if not mesh.is_local(idx):
            continue
        xv = (x[idx] if isinstance(x, np.ndarray) and x.dtype == object
              else x).to(mesh.devices[idx])
        tl = taps_local[idx]
        kl = tl.shape[0]
        k = n * kl
        nout = xv.shape[0] - (k - 1)
        start = k - kl - axis_index(mesh, axis_name, idx) * kl
        partial[idx] = fir_filter(xv[start:start + nout + kl - 1], tl, decim)
    return psum(partial, mesh, axis_name)
