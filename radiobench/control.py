"""Readings that the limits of ``radiobench/limits/<workload>.json`` are set
from, in one process: the program's numbers on some seeds, and the
control's, the plain reference at the precision below the configuration's
put in the program's place, on others.

    python3 -m radiobench.control --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...]

Each seed runs the cell as ``radiobench.run`` does (set-up, a window of
``--seconds``, the check), on the card.  One line a run, then for each
number the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

from radiobench.run import fixed_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    root = Path.cwd()
    fixed_cache_dirs(root)

    import torch

    from radiobench import bench

    if not torch.cuda.is_available():
        print("radiobench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    readings = {"program": {}, "control": {}}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            res = bench.run_cell(root, args.workload, seed, args.seconds, False,
                                 program_control=side == "control")
            nums = {k: c["value"] for k, c in res["checks"].items()}
            for k, v in nums.items():
                readings[side].setdefault(k, []).append(v)
            print(json.dumps({"side": side, "seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"], "numbers": nums,
                              "metrics": res["metrics"]}), flush=True)
            del res
            gc.collect()
            torch.cuda.empty_cache()
    summary = {k: {"program_max": max(readings["program"].get(k, [float("nan")])),
                   "control_min": min(readings["control"].get(k, [float("nan")]))}
               for k in set(readings["program"]) | set(readings["control"])}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
