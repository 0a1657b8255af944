"""One cell, one seed, one window: set-up, a closed loop of requests, the
check against the plain reference, and the metrics.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- ``radiobench/configs/<config>.json``: the configuration's sizes;
- ``radiobench/systems/<config>.py``: how the port is built for it
  (``sources`` and ``graph``);
- ``radiobench/reference/<config>.py``: its plain reference (``compare``
  and ``control``);
- ``radiobench/traffic/<traffic>.json``: the traffic mix (``traffic.py``);
- ``radiobench/limits/<workload>.json``: the limit of each number compared;
- ``radiobench/metrics/<metric>.py``: each per-layer metric's reader.

A later cell, configuration or metric adds files and entries; nothing
here names one.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from radiobench import hostrecord
from radiobench import trace as tracing
from radiobench import traffic

HERE = Path(__file__).resolve().parent


def since_process_start() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def module(kind: str, name: str):
    """``<kind>/<name>.py``; a metric ``<base>.<cells>`` without a file of
    its own is read by ``<kind>/<base>.py``, the same quantity in other
    cells."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"radiobench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str):
    """(the benchmark, the cell's entry, its configuration, traffic mix and
    limits) from the files ``BENCHMARK.json`` names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"radiobench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    mix = traffic.load(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return bench, cell, cfg, mix, limits


class Entry:
    """How a request enters the program: ``StreamExecutor.run`` on the
    request's samples, ``device_loop`` as the traffic mix says."""

    def __init__(self, system, cfg: dict, mix: dict, device):
        from grtpu_torch import StreamExecutor

        self.ex = StreamExecutor(system.graph(cfg), chunk_size=mix["chunk"],
                                 device=device)
        loop = bool(mix.get("device_loop", False))
        self.fn = lambda x: self.ex.run(x, device_loop=loop)
        self._pinned = {}

    def readback(self, out):
        """The request's output on the host, as numpy arrays (a tuple of
        them for several output pads).  A tensor on the card is copied into
        a page-locked buffer of its own, made in set-up, where the warm-up
        requests size it, and reused by every request: the copy is the DMA
        alone, with no page faults and no host-side memcpy in it, so the
        host's memory placement does not set a request's time.  The arrays
        are valid until the next request's readback (``own`` keeps one)."""
        if isinstance(out, (tuple, list)):
            return tuple(self._to_host(o, i) for i, o in enumerate(out))
        return self._to_host(out, 0)

    def _to_host(self, t: torch.Tensor, slot: int):
        if t.device.type == "cpu":
            return t.numpy()
        buf = self._pinned.get(slot)
        if buf is None or buf.dtype != t.dtype or buf.numel() < t.numel():
            buf = self._pinned[slot] = torch.empty(
                2 * t.numel(), dtype=t.dtype, pin_memory=True)
        host = buf[:t.numel()].view(t.shape)
        host.copy_(t)
        return host.numpy()


def own(host):
    """A copy of a readback that outlives the next request."""
    if isinstance(host, tuple):
        return tuple(own(h) for h in host)
    return np.array(host, copy=True)


def _request_input(sources, plan, mix, r):
    """Request ``r``'s samples, (n,)."""
    src, at = plan.slot(r)
    return sources[src, 0, at:at + mix["request_samples"]]


def _checks(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]["max"]} for k in limits}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             program_control: bool = False) -> dict:
    """Run one cell and return its result line as a dict.

    ``overrides`` replaces keys of the configuration (``"config"``) and the
    traffic mix (``"traffic"``): the CPU tests run the same path at a size a
    test can hold.  ``program_control`` puts the reference, at the
    precision below the configuration's, in the program's place for the
    check (the control's readings).  The result's ``host`` object records
    where the process ran (``hostrecord.describe``) and ``us_chunk``, the
    host's mean microseconds a chunk over the window's untraced requests."""
    bench, cell, cfg, mix, limits = load_cell(root, workload)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    system = module("systems", cell["config"])
    reference = module("reference", cell["config"])
    plan = traffic.Plan(mix, seed)
    cuda = torch.device(device).type == "cuda"
    sources = system.sources(cfg, mix, seed, device)
    entry = Entry(system, cfg, mix, device)
    outputs = {}
    for r in range(mix["warmup_requests"]):
        out = entry.readback(entry.fn(_request_input(sources, plan, mix, r)))
        if plan.kept(r):
            outputs[r] = own(out)
    if cuda:
        torch.cuda.synchronize()

    from grtpu_torch.ops import cuda_fir

    # A --trace 1 run serves untraced requests up to ``trace_seconds``
    # before the window's end (host_us_chunk reads them), then keeps the
    # profiler on for ``trace_seconds`` from the moment it is up (its start
    # takes seconds, which the traced window leaves out).
    trace_from = (max(0.0, seconds - mix["trace_seconds"]) if trace and cuda
                  else float("inf"))
    span = lambda name: contextlib.nullcontext()   # noqa: E731
    prof, untraced, launches0, t_prof = None, 0, {}, 0.0
    setup_s = since_process_start()
    r = mix["warmup_requests"]
    lat, entry_s, failed, out = [], [], 0, None
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < seconds if prof is None
           else time.perf_counter() - t_prof < mix["trace_seconds"]):
        if prof is None and time.perf_counter() - t0 >= trace_from:
            untraced = len(lat)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
            launches0 = dict(cuda_fir.launches)
            span = torch.profiler.record_function
        try:
            with span("rb.request"):
                with span("rb.traffic"):
                    x = _request_input(sources, plan, mix, r)
                ts = time.perf_counter()
                with span("rb.entry"):
                    out = entry.fn(x)
                te = time.perf_counter()
                with span("rb.readback"):
                    host = entry.readback(out)
                tr = time.perf_counter()
        except Exception:   # a request that fails is counted; the run ends
            traceback.print_exc()
            failed += 1
            break
        lat.append(tr - ts)
        entry_s.append(te - ts)
        if plan.kept(r):
            outputs[r] = own(host)
        r += 1
    t_end = time.perf_counter()
    if prof is not None:
        launches = {k: v - launches0.get(k, 0) for k, v in cuda_fir.launches.items()}
        prof.__exit__(None, None, None)
    n_req = len(lat)
    untraced_entry_s = entry_s[:untraced] or entry_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if n_req >= 6:   # warm-up left inside the window shows as a slow first part
        parts = np.array_split(np.array(lat[:untraced or n_req]) * 1e3, 6)
        print("radiobench: mean ms a request, each sixth of the window:",
              " ".join(f"{p.mean():.4f}" for p in parts), file=sys.stderr)

    # the check: the program's objects freed first
    del entry, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if program_control:
        outputs = reference.control(cfg, mix, sources, plan, sorted(outputs), r)
    numbers = reference.compare(cfg, mix, sources, plan, outputs, r)
    checks = _checks(numbers, limits)
    correct = (failed == 0 and n_req > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    result = {"correct": bool(correct), "attempted": n_req + failed,
              "failed": failed, "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(peak)}}
    if not trace:
        wall = t_end - t0
        # an end-to-end metric <base>.<cells> is <base> with a bound of its own
        values = {"input_rate": n_req * plan.samples_per_request / wall / 1e6,
                  "req_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat
                  else float("inf"),
                  "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
            for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    elif prof is not None:
        tr_ = tracing.reduce(prof)
        ctx = {"trace": tr_, "entry_s": untraced_entry_s,
               "launches": launches, "cfg": cfg, "mix": mix}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = module("metrics", m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if tr_ is not None:
            result["device"]["busy_s"] = tr_.busy_s
            result["device"]["window_s"] = tr_.window_s
            result["breakdown"] = {"device_ops": tracing.device_ops(tr_),
                                   "idle_gaps": tracing.idle_gaps(tr_)}
        # what the profiler costs: a request's mean time before and under it
        result["profiler"] = {
            "untraced_ms_req": 1e3 * float(np.mean(lat[:untraced])) if untraced
            else None,
            "traced_ms_req": 1e3 * float(np.mean(lat[untraced:]))
            if len(lat) > untraced else None}
    result["host"] = {
        **hostrecord.describe(torch.cuda.get_device_properties(0) if cuda else None),
        "us_chunk": module("metrics", "host_us_chunk").read(
            {"entry_s": untraced_entry_s, "mix": mix})}
    result["checks"] = checks
    return result
