"""The one traffic generator: a closed loop over sources made at set-up.

A traffic mix is a JSON file of parameters in ``radiobench/traffic/``:

- ``device_loop``: whether ``StreamExecutor.run`` replays its step from
  CUDA graphs;
- ``chunk``: the executor's chunk size;
- ``sources``, ``source_samples``: the distinct signals made at set-up from
  the seed, each ``source_samples`` long;
- ``request_samples``: the samples a request takes from a source, walking
  it front to back and then on to the next source, from the last back to
  the first, so that a stream stays continuous across requests;
- ``warmup_requests``: requests served in set-up, through the same object
  the window uses (they fill its state, caches and captured graphs);
- ``check_every``: outputs kept for the check, one request in this many,
  at an offset drawn from the seed;
- ``trace_seconds``: how long a ``--trace 1`` run keeps the profiler on,
  at the end of the window.

A configuration's reference may read further keys (the WBFM reference's
``prefix_samples``: how far before a request it starts).

Each request is handed over when the previous one's output is on the host.
Every seed gets the same sizes and the same number of requests a second
of work; only the signals' contents differ.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

KEYS = ("chunk", "sources", "source_samples", "request_samples",
        "warmup_requests", "check_every", "trace_seconds")


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"{path}: traffic mix lacks {missing}")
    if mix["source_samples"] % mix["request_samples"]:
        raise ValueError(f"{path}: request_samples must divide source_samples")
    if mix["request_samples"] % mix["chunk"]:
        raise ValueError(f"{path}: chunk must divide request_samples")
    return mix


class Plan:
    """Which samples request ``r`` takes, counted from the first warm-up
    request (r = 0), and which requests keep their output for the check."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.per_source = mix["source_samples"] // mix["request_samples"]
        self.check_offset = int(np.random.default_rng(
            [int(seed) % (1 << 64), 4]).integers(mix["check_every"]))

    def slot(self, r: int):
        """(source index, first sample) of request ``r``."""
        src = (r // self.per_source) % self.mix["sources"]
        return src, (r % self.per_source) * self.mix["request_samples"]

    def kept(self, r: int) -> bool:
        return r % self.mix["check_every"] == self.check_offset

    @property
    def samples_per_request(self) -> int:
        return self.mix["request_samples"]
