"""Shared sizes for the CPU tests: each cell's own path at a size a test
run can hold (the timed sizes run only on the card)."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "wbfm_rcv256.file": {"traffic": {
        "chunk": 16384, "sources": 2, "source_samples": 65536,
        "request_samples": 65536, "prefix_samples": 16384, "check_every": 2}},
    "dmr_4fsk48k.stream": {"traffic": {"source_samples": 17280 * 6}},
}
SEED = 2 ** 31 + 12345      # larger than 32 signed bits hold


@pytest.fixture(scope="session")
def bench_root():
    return ROOT


def run_tiny(root, workload, seed=SEED, **kw):
    from radiobench import bench

    return bench.run_cell(root, workload, seed, 1.0, False, device="cpu",
                          overrides=TINY[workload], **kw)
