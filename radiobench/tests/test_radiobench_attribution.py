"""The attribution of device time to the program's blocks and executor
(``radiobench/attribution.py``), on synthetic profiler events: a graph
launch matched to its piece's node map, a count that differs going to
``unmatched``, eager work put down by the spans around its launch, idle
gaps named by the harness's and the program's spans; and the existing
metrics unchanged by the program's host spans."""

from types import SimpleNamespace

import pytest

from radiobench import attribution as A
from radiobench import bench, trace


class Ev:
    def __init__(self, name, start, end, corr=0, cpu=True):
        self._n, self._a, self._b, self._c = name, start, end, corr
        self._d = SimpleNamespace(name="CPU" if cpu else "CUDA")

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def correlation_id(self):
        return self._c


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


# one request: a replayed piece (a graph of 5 nodes: executor 1, Demod 2,
# Fir 1, executor 1), an eager copy inside grtpu.outputs, the readback's copy
NODE_MAP = {"top.0": [("executor", 1), ("Demod", 2), ("Fir", 1),
                      ("executor", 1)]}


def request_events(n_graph=5):
    ev = [Ev("rb.request", 0, 1000), Ev("rb.entry", 10, 800),
          Ev("grtpu.run", 20, 790), Ev("grtpu.piece:top.0", 100, 200),
          Ev("cudaGraphLaunch", 110, 190, corr=7),
          Ev("grtpu.outputs", 300, 400),
          Ev("cudaMemcpyAsync", 310, 320, corr=8),
          Ev("rb.readback", 810, 990),
          Ev("cudaMemcpyAsync", 820, 830, corr=9)]
    t = 200
    for i in range(n_graph):
        ev.append(Ev(f"kernel_{i}", t, t + 40, corr=7, cpu=False))
        t += 50
    ev += [Ev("Memcpy DtoD", 460, 480, corr=8, cpu=False),
           Ev("Memcpy DtoH", 850, 950, corr=9, cpu=False)]
    return ev


def test_graph_launch_matched_to_its_node_map():
    att = A.attribute(A.collect(prof(request_events())), NODE_MAP)
    assert att.owner_ns == {"executor": 80 + 20, "Demod": 80, "Fir": 40,
                            "readback": 100}
    assert att.mismatches == []
    assert att.named_share() == 1.0
    assert A.executor_device_ms_req(att) == pytest.approx(100e-6)
    assert [o for o, _ in att.device_blocks()][0] in ("executor", "readback")


def test_count_mismatch_goes_to_unmatched_whole():
    att = A.attribute(A.collect(prof(request_events(n_graph=6))), NODE_MAP)
    assert att.owner_ns["unmatched"] == 6 * 40
    assert set(att.owner_ns) == {"unmatched", "executor", "readback"}
    assert att.mismatches == [{"piece": "grtpu.piece:top.0", "events": 6,
                               "nodes": 5, "kinds": {"kernel": 6}}]
    # the sixth kernel (450-490) covers the eager copy (460-480)
    assert att.named_share() == pytest.approx(1 - 240 / (240 + 100))


def test_eager_work_goes_to_the_innermost_block():
    ev = [Ev("rb.request", 0, 100), Ev("rb.entry", 0, 90),
          Ev("grtpu.run", 1, 89), Ev("grtpu.block:Mm", 10, 30),
          Ev("cudaLaunchKernel", 12, 14, corr=3),
          Ev("grtpu.push_read:Mm", 40, 60),
          Ev("cudaLaunchKernel", 41, 42, corr=4),
          Ev("k", 20, 25, corr=3, cpu=False),
          Ev("k", 50, 55, corr=4, cpu=False),
          Ev("k", 70, 75, corr=99, cpu=False)]        # no launch seen
    att = A.attribute(A.collect(prof(ev)), {})
    assert att.owner_ns == {"Mm": 5, "executor": 5, "unmatched": 5}


def test_gaps_carry_the_program_span():
    att = A.attribute(A.collect(prof(request_events())), NODE_MAP)
    assert [[n, round(s * 1e9)] for n, s in att.gaps] == [
        ["entry/grtpu.run", 370], ["request", 200], ["readback", 50],
        ["entry/grtpu.run", 20], ["entry/grtpu.run", 10],
        ["entry/grtpu.run", 10], ["entry/grtpu.outputs", 10],
        ["entry/grtpu.outputs", 10]]
    assert A.gap_label(("rb.request", "rb.entry", "grtpu.run",
                        "grtpu.push_read:Mm")) == "entry/grtpu.push_read:Mm"
    assert A.gap_label(()) == "between requests"


def test_open_spans_nest():
    spans = sorted([(0, 100, "a"), (10, 50, "b"), (20, 30, "c"),
                    (60, 70, "d")], key=lambda s: (s[0], -s[1]))
    assert A.open_spans(spans, [5, 25, 40, 65, 80, 150]) == [
        ("a",), ("a", "b", "c"), ("a", "b"), ("a", "d"), ("a",), ()]


def test_no_stats_reads_none():
    assert A.per_chunk_us(None, {"chunks": 3, "replay_s": 1.0},
                          "replay_s") is None
    assert A.per_chunk_us({"chunks": 3, "replay_s": 1.0},
                          {"chunks": 3, "replay_s": 2.0}, "replay_s") is None
    assert A.per_chunk_us({"chunks": 1, "replay_s": 1.0},
                          {"chunks": 3, "replay_s": 2.0},
                          "replay_s") == pytest.approx(5e5)
    assert A.executor_device_ms_req(None) is None
    assert A.attribute(A.Events([], {}, []), {}) is None


def test_program_host_spans_leave_the_existing_metrics():
    """trace.reduce keeps only the harness's host spans: the program's
    (host ranges with no mirror on the card) change no existing metric."""
    base = [e for e in request_events() if not e.name().startswith("grtpu.")]

    def ctx(tr):
        return {"trace": tr, "launches": {"fir_decim_mma_fwd": 1},
                "entry_s": [1e-3], "mix": {"request_samples": 8, "chunk": 4},
                "cfg": {"fir_launches": []}}

    a = ctx(trace.reduce(prof(base)))
    b = ctx(trace.reduce(prof(request_events())))
    for name in ("device_idle", "device_ms_req", "device_ops_chunk",
                 "fir_roofline", "host_us_chunk"):
        m = bench.module("metrics", name)
        assert m.read(a) == m.read(b)
    assert a["trace"].gaps == b["trace"].gaps
    assert trace.idle_gaps(a["trace"]) == trace.idle_gaps(b["trace"])
