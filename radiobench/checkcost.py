"""What the check of a cell costs at a given number of requests, without
serving them: the cell's sources made as a run makes them, the control
(the reference at the precision below the configuration's) put in the
program's place for requests 0 to ``--requests - 1`` as ``program_control``
does, then the reference's ``compare`` on those outputs, timed.

    python3 -m radiobench.checkcost --workload <cell> --seed <n> --requests <n>

Prints one JSON line: the seconds of the control and of ``compare``, the
card memory that ``compare`` allocated above what was held before it
(``torch.cuda.max_memory_allocated``), and how far the process's resident
memory rose above its level before ``compare`` (sampled every 5 ms from
``/proc/self/statm``), with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

from radiobench.run import fixed_cache_dirs

PAGE = os.sysconf("SC_PAGE_SIZE")


def resident_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


class PeakResident:
    """The highest resident memory seen while the block runs."""

    def __enter__(self):
        self.peak, self._stop = resident_bytes(), threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, resident_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, resident_bytes())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    fixed_cache_dirs(root)

    import torch

    from radiobench import bench, traffic

    _, cell, cfg, mix, _ = bench.load_cell(root, args.workload)
    if not torch.cuda.is_available():
        print("radiobench.checkcost: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    system = bench.module("systems", cell["config"])
    reference = bench.module("reference", cell["config"])
    plan = traffic.Plan(mix, args.seed)
    sources = system.sources(cfg, mix, args.seed, "cuda")
    n = args.requests
    t0 = time.perf_counter()
    outputs = reference.control(cfg, mix, sources, plan, list(range(n)), n)
    control_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = resident_bytes()
    with PeakResident() as rss:
        t0 = time.perf_counter()
        numbers = reference.compare(cfg, mix, sources, plan, outputs, n)
        compare_s = time.perf_counter() - t0
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "requests": n,
        "samples": n * mix["request_samples"], "control_s": control_s,
        "compare_s": compare_s,
        "card_bytes": torch.cuda.max_memory_allocated() - held,
        "host_growth_bytes": rss.peak - before, "host_before_bytes": before,
        "numbers": numbers,
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
