"""Tracing / profiling / invariant checks (SURVEY.md §5.1-5.2).

Port of ``grtpu.utils.trace``.  The reference's pieces:

* scheduler iteration logs (``ENABLE_LOGGING`` sst-NNN.log,
  gr_block_executor.cc:38-45) -> :class:`TracedExecutor` writing one line
  per time-block step: step index, per-edge item counts, wall time
  (grtpu's line format).
* per-implementation micro benchmarks (benchmark_dotprod_*.cc:36-38,
  benchmark_filters.py) -> :func:`block_timings` timing each block's
  ``apply`` alone on the executor's device: CUDA events on the card (the
  median of rounds), ``perf_counter`` on the CPU.
* gruel::high_res_timer -> :func:`high_res_timer_now` (monotonic ns).
* the profiler the reference never had -> :func:`profile` over
  ``torch.profiler``, writing a Chrome trace (chrome://tracing, Perfetto).
* race-detector stand-in (§5.2: the functional model removes data races;
  keep invariant checks instead) -> :func:`validate_state` checking that
  the state tree keeps its structure/shape/dtype across steps and holds no
  NaN/Inf.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, TextIO

import numpy as np
import torch

from grtpu_torch.runtime.executor import _AttrKey, _leaves, _tree_to


def high_res_timer_now() -> int:
    """Monotonic nanosecond tick (gruel/high_res_timer.h:25-111)."""
    return time.monotonic_ns()


@contextlib.contextmanager
def profile(logdir: str):
    """Op- and kernel-level profiling: ``with profile('/tmp/tb') as prof:
    ex.run(...)``.

    Records the host and, where CUDA is available, the card; at exit writes
    ``logdir/trace_<pid>.json``, a Chrome trace of everything run inside
    the context.  Yields the ``torch.profiler.profile`` object
    (``key_averages()`` for sums by op and kernel)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ step tracing

class TracedExecutor:
    """Wrap a StreamExecutor; log one line per step (sst-NNN.log analog).

    Line format:
      step=N wall_ms=X items={edge: count, ...} [tail_sums={edge: sum}]
    The wall time waits for the card (synchronize) before it is read.
    """

    def __init__(self, executor, file: Optional[TextIO] = None,
                 state_norms: bool = False):
        self.ex = executor
        self.file = file
        self.state_norms = state_norms
        self.lines: List[str] = []
        self._n = 0

    def step(self, *ext_inputs):
        t0 = time.perf_counter()
        out = self.ex.step(*ext_inputs)
        _sync(self.ex.device)
        ms = (time.perf_counter() - t0) * 1e3
        line = (f"step={self._n} wall_ms={ms:.3f} "
                f"items={dict(self.ex.edge_items)}")
        if self.state_norms:
            norms = {k: float(torch.real(v).to(torch.float32).sum())
                     for k, v in self.ex.state["tails"].items()}
            line += f" tail_sums={norms}"
        self._n += 1
        self.lines.append(line)
        if self.file:
            self.file.write(line + "\n")
            self.file.flush()
        return out

    def __getattr__(self, name):
        return getattr(self.ex, name)


# ------------------------------------------------------- per-block timing

def _example_input(port, n: int, device) -> torch.Tensor:
    shape = port.chunk_shape(n)
    r = np.random.RandomState(0)
    if port.dtype.is_complex:
        x = (r.randn(*shape) + 1j * r.randn(*shape)).astype(np.complex64)
    elif port.dtype.is_floating_point:
        x = r.randn(*shape).astype(np.float32)
    else:
        return torch.zeros(shape, dtype=port.dtype, device=device)
    return torch.from_numpy(x).to(device=device, dtype=port.dtype)


def _ms(fn, device: torch.device) -> float:
    """Milliseconds of one ``fn()``: CUDA events on the card, the host
    clock elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def block_timings(executor, iters: int = 4) -> Dict[str, float]:
    """Per-block time (ms per chunk), each block's ``apply`` called alone on
    the executor's device at its chunk shape, on random example inputs and
    its initial state: the median of ``iters`` timed calls after one
    warm-up.  Identifies which stage bounds a flowgraph (the
    benchmark_dotprod / benchmark_filters analog).  A block whose ``apply``
    cannot run alone on such inputs reads NaN."""
    dev = executor.device
    res: Dict[str, float] = {}
    for b in executor.order:
        n_in = executor.block_nin[b.uid]
        state = _tree_to(b.init_state(), dev)
        if b.in_ports:
            ins = [_example_input(p, n_in + max(0, b.history - 1), dev)
                   for p in b.in_ports]

            def call(b=b, state=state, ins=ins):
                b.apply(state, *ins)
        else:
            kw = {"device": dev} if b.source_takes_device else {}

            def call(b=b, state=state, n=n_in // b.decim * b.interp, kw=kw):
                b.apply(state, n, **kw)
        try:
            _ms(call, dev)  # warm-up
            res[b.name] = float(np.median([_ms(call, dev)
                                           for _ in range(iters)]))
        except (RuntimeError, ValueError, TypeError, IndexError):
            res[b.name] = float("nan")
    return res


# --------------------------------------------------------- invariant check

def _keystr(path) -> str:
    return "".join(f".{p}" if isinstance(p, _AttrKey) else f"[{p!r}]"
                   for p in path)


def validate_state(executor, reference_state=None) -> List[str]:
    """State-invariant checks (the §5.2 guard-rail replacement): the state
    tree must keep its structure (the paths of its tensors) and each
    tensor's shape and dtype (against ``reference_state`` where given), and
    hold no NaN/Inf (real and imaginary parts counted apart).  Returns a
    list of violation strings (empty = clean)."""
    problems: List[str] = []
    leaves = list(_leaves(executor.state))
    if reference_state is not None:
        ref = list(_leaves(reference_state))
        if [p for p, _ in leaves] != [p for p, _ in ref]:
            problems.append(f"structure changed: {[_keystr(p) for p, _ in ref]}"
                            f" -> {[_keystr(p) for p, _ in leaves]}")
        else:
            for (path, a), (_, b) in zip(leaves, ref):
                if a.shape != b.shape or a.dtype != b.dtype:
                    problems.append(
                        f"{_keystr(path)}: {tuple(b.shape)}/{b.dtype} -> "
                        f"{tuple(a.shape)}/{a.dtype}")
    for path, leaf in leaves:
        if leaf.is_complex():
            bad = int((~torch.isfinite(leaf.real)).sum()
                      + (~torch.isfinite(leaf.imag)).sum())
        elif leaf.is_floating_point():
            bad = int((~torch.isfinite(leaf)).sum())
        else:
            continue
        if bad:
            problems.append(f"{_keystr(path)}: {bad} non-finite")
    return problems
