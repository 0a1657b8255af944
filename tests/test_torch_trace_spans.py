"""The executor's spans and counters (``grtpu_torch.utils.trace.span``,
``StreamExecutor.loop_stats`` and ``loop_node_map``) on the CPU.

The DMR 4FSK chain (QuadratureDemod -> matched RRC -> ClockRecoveryMMFF ->
FourLevelSlicer; dibits and soft symbols out) at a test's size: under a CPU
``torch.profiler`` its eager and ``device_loop`` runs open the ``grtpu.``
spans, each inside the one it belongs to; with no profiler they open none;
the loop's counters count chunks, piece calls and push reads exactly.  The
node map's bookkeeping runs here on a stub count; the map of a captured
graph is checked on the card (``tests/test_torch_cuda_trace.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks.analog import QuadratureDemod  # noqa: E402
from grtpu_torch.blocks.filter import FirFilter  # noqa: E402
from grtpu_torch.digital.blocks import (ClockRecoveryMMFF,  # noqa: E402
                                        FourLevelSlicer)
from grtpu_torch.digital.modems import Fsk4Modem  # noqa: E402
from grtpu_torch.runtime.device_loop import DeviceLoop, new_stats  # noqa: E402
from grtpu_torch.utils import trace  # noqa: E402

SPS, CHUNK, CHUNKS = 10, 480, 4
STAT_KEYS = {"chunks", "piece_calls", "replays", "replay_s", "push_reads",
             "push_wait_s", "captures", "capture_s"}


def dmr_executor():
    """(executor, the clock recovery's name, the slicer's name, every
    block's name in the chain's order)."""
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    mm = ClockRecoveryMMFF(omega=SPS, gain_omega=0.25 * 0.05 ** 2, mu=0.5,
                           gain_mu=0.05, omega_relative_limit=0.005)
    sl = FourLevelSlicer(scale=3.0)
    demod = QuadratureDemod(1.0 / modem.sensitivity)
    rrc = FirFilter(1, modem.rx_taps / SPS, "fff")
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    dibits = g.add_output(Port(torch.uint8))
    levels = g.add_output(Port(torch.float32))
    g.connect(pin, demod, rrc, mm, sl, dibits)
    g.connect(mm, levels)
    ex = StreamExecutor(g, chunk_size=CHUNK, device="cpu")
    return ex, mm.name, sl.name, [demod.name, rrc.name, mm.name, sl.name]


def signal(chunks=CHUNKS, seed=0):
    d = np.random.RandomState(seed).randint(0, 4, chunks * CHUNK // SPS)
    freq = np.repeat((2 * d - 3) / 3.0 * 0.25, SPS)
    return np.exp(1j * np.cumsum(freq)).astype(np.complex64)


def program_spans(prof):
    """(start, end, name) of the ``grtpu.`` ranges a profiler recorded."""
    return sorted(((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("grtpu.")),
                  key=lambda s: (s[0], -s[1]))


def parents(spans):
    """{span name: the set of names of the spans directly around it}."""
    out, stack = {}, []
    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            stack.pop()
        out.setdefault(s[2], set()).add(stack[-1][2] if stack else None)
        stack.append(s)
    return out


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return program_spans(prof)


def test_device_loop_run_opens_the_spans_nested():
    ex, mm, sl, blocks = dmr_executor()
    x = signal()
    ex.run(x, device_loop=True)
    up = parents(profiled(lambda: ex.run(x, device_loop=True)))
    top, emit = "grtpu.piece:top.0", f"grtpu.piece:{mm}.0"
    assert up["grtpu.run"] == {None}
    for name in ("grtpu.load", "grtpu.copy_in", top, f"grtpu.push_read:{mm}",
                 emit, "grtpu.outputs", "grtpu.unload", "grtpu.finalize"):
        assert up[name] == {"grtpu.run"}, name
    # on the CPU every piece call runs its blocks' apply
    for b in blocks[:3]:
        assert up[f"grtpu.block:{b}"] == {top}
    assert up[f"grtpu.block:{sl}"] == {emit}
    assert not any(n.startswith("grtpu.capture:") for n in up)


def test_eager_run_opens_the_spans_nested():
    ex, mm, sl, blocks = dmr_executor()
    up = parents(profiled(lambda: ex.run(signal())))
    assert up["grtpu.run"] == {None}
    for b in blocks:
        assert up[f"grtpu.block:{b}"] == {"grtpu.run"}
    assert up[f"grtpu.push_read:{mm}"] == {"grtpu.run"}
    assert up["grtpu.finalize"] == {"grtpu.run"}
    assert not any(n.startswith(("grtpu.piece:", "grtpu.load"))
                   for n in up)


def test_span_counts_match_the_chunks():
    ex, mm, sl, _ = dmr_executor()
    x = signal()
    ex.run(x, device_loop=True)
    before = ex.loop_stats()["piece_calls"]
    spans = profiled(lambda: ex.run(x, device_loop=True))
    names = [s[2] for s in spans]
    n_emit = ex.loop_stats()["piece_calls"] - before - CHUNKS
    assert names.count("grtpu.copy_in") == CHUNKS
    assert names.count("grtpu.piece:top.0") == CHUNKS
    assert names.count(f"grtpu.push_read:{mm}") == CHUNKS
    assert names.count(f"grtpu.piece:{mm}.0") == n_emit > 0
    assert names.count("grtpu.outputs") == CHUNKS


@pytest.mark.parametrize("device_loop", [False, True])
def test_no_profiler_enters_no_record_function(monkeypatch, device_loop):
    calls = []

    def counting(original):
        def enter(*a, **k):
            calls.append(a)
            return original(*a, **k)
        return enter

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting(torch.autograd.profiler.record_function))
    ex, *_ = dmr_executor()
    x = signal()
    ex.run(x, device_loop=device_loop)
    ex.run(x, device_loop=device_loop)
    assert calls == []
    profiled(lambda: ex.run(x, device_loop=device_loop))
    assert calls                       # the same run under a profiler


def test_span_is_one_shared_no_op_without_a_profiler():
    assert trace.span("grtpu.a") is trace.span("grtpu.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("grtpu.a") is not trace.span("grtpu.a")


@pytest.mark.parametrize("chunks", [1, 3, 6])
def test_loop_stats_count_exactly(chunks):
    ex, mm, *_ = dmr_executor()
    assert ex.loop_stats() == new_stats()
    x = signal(chunks, seed=chunks)
    _, levels = ex.run(x, device_loop=True)
    st = ex.loop_stats()
    assert set(st) == STAT_KEYS
    uid = next(b.uid for b in ex.order if b.name == mm)
    n_emit = levels.shape[0] // ex.vr_emit[uid]
    assert st["chunks"] == chunks
    assert st["push_reads"] == chunks
    assert st["piece_calls"] == chunks + n_emit
    # no graph on the CPU: every piece call runs its step
    assert st["replays"] == st["captures"] == 0
    assert st["replay_s"] == st["capture_s"] == 0.0
    assert st["push_wait_s"] >= 0.0
    ex.run(x, device_loop=True)
    again = ex.loop_stats()
    assert again["chunks"] == 2 * chunks
    assert again["push_reads"] == 2 * chunks
    assert again["push_wait_s"] >= st["push_wait_s"]


def test_loop_stats_is_a_copy_and_eager_runs_leave_it():
    ex, *_ = dmr_executor()
    x = signal()
    ex.run(x, device_loop=True)
    st = ex.loop_stats()
    st["chunks"] = -1
    assert ex.loop_stats()["chunks"] == CHUNKS
    ex.run(x)
    assert ex.loop_stats()["chunks"] == CHUNKS


def test_node_map_is_empty_without_a_capture():
    ex, *_ = dmr_executor()
    assert ex.loop_node_map() == {}
    ex.run(signal(), device_loop=True)
    assert ex.loop_node_map() == {}


def test_piece_names():
    ex, mm, *_ = dmr_executor()
    ex.run(signal(), device_loop=True)
    assert sorted(ex._device_loop.labels.values()) == sorted(
        ["top.0", f"{mm}.0"])


@pytest.mark.parametrize("marks, runs", [
    # (owner, nodes captured so far) at each mark -> the map's runs
    ([("executor", 0), ("A", 3), ("executor", 5), ("B", 5), ("executor", 6)],
     [("A", 3), ("executor", 3)]),
    ([("executor", 2), ("A", 2), ("executor", 2), ("B", 4)],
     [("executor", 2), ("B", 2)]),
    ([("executor", 1), ("executor", 4), ("A", 7)],
     [("executor", 4), ("A", 3)]),
])
def test_marks_make_runs(marks, runs):
    loop = DeviceLoop.__new__(DeviceLoop)
    counts = iter(n for _, n in marks)
    loop._counter, loop._runs = (lambda: next(counts)), []
    for owner, _ in marks:
        loop._mark(owner)
    assert loop._runs == runs
