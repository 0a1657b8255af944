"""The check of ``wbfm_rtl2048.file`` at a size a CPU test can hold: the
program passes; the control, each fault a cell can have and the rotator
grtpu has (a float32 ramp, reduced after it is rounded) make it fail; and
``xlate_roofline`` reads a synthetic trace."""

import pytest
import torch

from radiobench import bench
from radiobench.tests.conftest import SEED
from radiobench.tests.test_radiobench_checks import (_answer_altered,
                                                     _half_left_out,
                                                     _state_unchanged)
from radiobench.trace import Trace

CELL = "wbfm_rtl2048.file"
TINY = {"traffic": {
    "chunk": 16384, "sources": 2, "source_samples": 65536,
    "request_samples": 65536, "prefix_samples": 16384, "check_every": 2}}
# one chunk a request: the ramp's length at which grtpu's rotator shows
ONE_CHUNK = {"traffic": {**TINY["traffic"], "chunk": 65536}}


def run_tiny(root, overrides=TINY, **kw):
    return bench.run_cell(root, CELL, SEED, 1.0, False, device="cpu",
                          overrides=overrides, **kw)


@pytest.mark.parametrize("overrides", [TINY, ONE_CHUNK],
                         ids=["chunk16384", "chunk65536"])
def test_program_passes(overrides, bench_root):
    res = run_tiny(bench_root, overrides)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"input_rate.file", "req_p95_ms.file",
                                   "setup_s"}


def test_control_fails(bench_root):
    res = run_tiny(bench_root, program_control=True)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state", "half", "altered"])
def test_fault_fails(fault, monkeypatch, bench_root):
    fault(monkeypatch)
    res = run_tiny(bench_root)
    assert res["correct"] is False, res["checks"]


def _float32_ramp(phase, step, n, device):
    """grtpu's rotator: phase + step * k formed and rounded in float32,
    reduced only by the carried phase's wrap."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    ph = torch.as_tensor(phase, device=device).to(torch.float32)
    return ph + torch.tensor(float(step), dtype=torch.float32) * k


def _float32_advance(phase, step, n, device):
    ph = torch.as_tensor(phase, device=device).to(torch.float32)
    return torch.remainder(ph + torch.tensor(float(step) * n,
                                             dtype=torch.float32), 2 * torch.pi)


def test_float32_rotator_fails(monkeypatch, bench_root):
    from fractions import Fraction

    from grtpu_torch.ops import fir

    radians = lambda s: float(s) * 2 * torch.pi if isinstance(s, Fraction) \
        else s   # noqa: E731
    monkeypatch.setattr(fir, "phase_ramp", lambda p, s, n, d: _float32_ramp(
        p, radians(s), n, d))
    monkeypatch.setattr(fir, "phase_advance", lambda p, s, n, d:
                        _float32_advance(p, radians(s), n, d))
    res = run_tiny(bench_root, ONE_CHUNK)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["bad_shape"]["value"] == 0


def _trace(names, requests=2):
    device = [(1000 * i, 1000 * i + 500, n) for i, n in enumerate(names)]
    return Trace(window=(0, 1000 * len(names)), device=device, spans=[],
                 requests=requests)


CCC = "void fir_decim_mma_kernel<2, float, 8, 2>(float const*, float*, long)"
REAL = "void fir_decim_mma_kernel<2, float, 8, 0>(float const*, float*, long)"


def test_xlate_roofline_reads_a_synthetic_trace(bench_root):
    m = bench.module("metrics", "xlate_roofline")
    cfg = bench.load_cell(bench_root, CELL)[2]
    mix = {"chunk": 4194304, "request_samples": 8388608}
    ctx = {"trace": _trace([CCC, REAL, CCC, REAL]), "cfg": cfg, "mix": mix,
           "launches": {"fir_decim_cc": 2, "fir_decim_mma_fwd": 4}}
    bound = m.launch_bound_s(cfg["xlate_launch"], mix["chunk"])
    # bytes set it: 8 B x (inputs + 98 history + outputs + 99 taps)
    assert bound == pytest.approx(8 * (4194304 + 98 + 524288 + 99) / 3.35e12)
    assert m.read(ctx) == pytest.approx(100 * 2 * bound / 1e-6)
    assert m.read({**ctx, "launches": {"fir_decim_cc": 3}}) is None
    assert m.read({**ctx, "launches": {"fir_decim_cc": 0}}) is None
    assert m.read({**ctx, "launches": {}}) is None
    assert m.read({**ctx, "trace": _trace([REAL, REAL])}) is None
    assert m.read({**ctx, "trace": None}) is None
