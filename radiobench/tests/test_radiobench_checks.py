"""The check that decides ``correct``: the program passes, and the control
(the reference at the precision below the configuration's, in the
program's place) and each fault the cell can have make it fail."""

import pytest

from radiobench import bench
from radiobench.tests.conftest import TINY, run_tiny

CELLS = sorted(TINY)


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes(workload, bench_root):
    res = run_tiny(bench_root, workload)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, bench_root):
    res = run_tiny(bench_root, workload, program_control=True)
    assert res["correct"] is False, res["checks"]


def _state_unchanged(monkeypatch):
    from grtpu_torch import StreamExecutor

    run, step = StreamExecutor.run, StreamExecutor.step

    def fresh_run(self, *a, **k):       # every request from the initial state
        self.state = self._make_state()
        return run(self, *a, **k)

    def still_step(self, *a):           # a step that returns its state unchanged
        state = self.state
        out = step(self, *a)
        self.state = state
        return out

    monkeypatch.setattr(StreamExecutor, "run", fresh_run)
    monkeypatch.setattr(StreamExecutor, "step", still_step)


def _half_left_out(monkeypatch):
    init = bench.Entry.__init__

    def halved(self, *a, **k):
        init(self, *a, **k)
        fn = self.fn

        def call(x):
            x = x.clone()
            x[x.shape[-1] // 2:] = 0
            return fn(x)

        self.fn = call

    monkeypatch.setattr(bench.Entry, "__init__", halved)


def _answer_altered(monkeypatch):
    readback = bench.Entry.readback

    def altered(self, out):
        host = readback(self, out)
        if isinstance(host, tuple):       # (dibits, levels): one dibit flipped
            d = host[0].copy()
            d[tuple(n // 2 for n in d.shape)] ^= 1
            return (d,) + tuple(host[1:])
        a = host.copy()
        a[tuple(n // 2 for n in a.shape)] += 0.01
        return a

    monkeypatch.setattr(bench.Entry, "readback", altered)


FAULTS = [(w, "state", _state_unchanged) for w in CELLS] + [
    (w, "half", _half_left_out) for w in CELLS] + [
    (w, "altered", _answer_altered) for w in CELLS]


@pytest.mark.parametrize("workload,name,fault", FAULTS,
                         ids=[f"{w}-{n}" for w, n, _ in FAULTS])
def test_fault_fails(workload, name, fault, monkeypatch, bench_root):
    fault(monkeypatch)
    res = run_tiny(bench_root, workload)
    assert res["correct"] is False, res["checks"]
