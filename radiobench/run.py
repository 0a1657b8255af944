"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m radiobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, then ``host`` and ``check_s``, the
seconds the check took, and last ``checks``: each number compared beside
its limit); the last lines of standard error give the same numbers.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The run fails, printing no
result, where there is no CUDA device or fewer than the cell asks for,
and where JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BANNED = {"jax", "jaxlib", "flax", "grtpu"}


def fixed_cache_dirs(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's own kernels build into ``build/grtpu_torch``, beside these)."""
    cache = root / "build" / "radiobench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``grtpu_torch`` is not ``grtpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    fixed_cache_dirs(root)

    import torch

    from radiobench import bench

    _, cell, _, _, _ = bench.load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"radiobench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    result = bench.run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace))
    found = banned_modules()
    if found:
        print(f"radiobench: modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 3
    report(result)
    return 0


def report(result: dict):
    """Where the run ran, the check's seconds, then the numbers compared,
    each beside its limit, as the last lines of standard error; the result
    as the last line of standard output."""
    print(f"radiobench: host {json.dumps(result['host'])}", file=sys.stderr,
          flush=True)
    print(f"radiobench: check_s {result['check_s']!r}", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
