"""``device_loop``'s node maps and counters on the card.

The WBFM receiver (QuadratureDemod -> the 617-tap decimating audio FIR on
the hand kernel -> FmDeemph) and the DMR 4FSK chain run under
``run(device_loop=True)``: each captured piece's node map gives every
block at least one node and sums to the device events that one launch of
its graph runs (one event a kernel, memcpy or memset node, all under the
launch's correlation id); the program's spans leave no mirror on the
card's timeline; the counters count the captures, replays and push reads.
Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.  The
file imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_trace.py -m cuda --noconftest
"""

import math
from collections import Counter

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
from grtpu_torch.models.fm import FmDeemph  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def wbfm_graph():
    taps = firdes.low_pass(1.0, 256e3, 15e3, 1e3, firdes.Window.HAMMING)
    g = Graph()
    g.connect(g.add_input(Port(torch.complex64)),
              QuadratureDemod(256e3 / (2 * math.pi * 75e3)),
              FirFilter(8, taps, "fff", impl="kernel"),
              FmDeemph(32e3, 75e-6), g.add_output(Port(torch.float32)))
    return g


def dmr_graph():
    modem = Fsk4Modem(samples_per_symbol=10, device="cpu")
    mm = ClockRecoveryMMFF(omega=10, gain_omega=0.25 * 0.05 ** 2, mu=0.5,
                           gain_mu=0.05, omega_relative_limit=0.005)
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    g.connect(pin, QuadratureDemod(1.0 / modem.sensitivity),
              FirFilter(1, modem.rx_taps / 10, "fff"), mm,
              FourLevelSlicer(scale=3.0), g.add_output(Port(torch.uint8)))
    g.connect(mm, g.add_output(Port(torch.float32)))
    return g, mm.name


def tone(n, step, dev):
    return torch.from_numpy(
        np.exp(1j * np.cumsum(np.full(n, step))).astype(np.complex64)).to(dev)


def launch_counts(ex, x):
    """Device events of each graph launch of one ``device_loop`` run, by
    piece name, and the names of the card's events.  The profiler runs
    one warm-up run first: its first launch may lose events."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ex.run(x, device_loop=True)
        torch.cuda.synchronize()
        ex.run(x, device_loop=True)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    runs = sorted(e.start_ns() for e in events if e.name() == "grtpu.run")
    pieces = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                    if e.name().startswith("grtpu.piece:"))
    launch = {}
    for e in events:
        if e.device_type().name == "CPU" and "GraphLaunch" in e.name() \
                and e.start_ns() > runs[-1]:
            t = e.start_ns()
            launch[e.correlation_id()] = next(
                n for a, b, n in pieces if a <= t < b)[len("grtpu.piece:"):]
    device = [e for e in events if e.device_type().name != "CPU"]
    counts = Counter(e.correlation_id() for e in device
                     if e.correlation_id() in launch)
    by_piece = {}
    for corr, n in counts.items():
        by_piece.setdefault(launch[corr], set()).add(n)
    return by_piece, {e.name() for e in device}


def check_map(ex, x, pieces):
    node_map = ex.loop_node_map()
    assert sorted(node_map) == sorted(pieces)
    owners = {o for runs in node_map.values() for o, _ in runs}
    assert owners == {b.name for b in ex.order} | {"executor"}
    assert all(n > 0 for runs in node_map.values() for _, n in runs)
    by_piece, names = launch_counts(ex, x)
    assert by_piece == {k: {sum(n for _, n in runs)}
                        for k, runs in node_map.items()}
    assert not any(n.startswith("grtpu.") for n in names)


def test_wbfm_node_map_sums_to_each_launch(dev):
    ex = StreamExecutor(wbfm_graph(), chunk_size=65536, device=dev)
    x = tone(4 * 65536, 0.3, dev)
    ex.run(x, device_loop=True)
    check_map(ex, x, ["top.0"])


def test_dmr_node_maps_sum_to_each_launch(dev):
    g, mm = dmr_graph()
    ex = StreamExecutor(g, chunk_size=480, device=dev)
    x = tone(4 * 480, 0.25, dev)
    ex.run(x, device_loop=True)
    check_map(ex, x, ["top.0", f"{mm}.0"])


def test_counters_on_the_card(dev):
    ex = StreamExecutor(wbfm_graph(), chunk_size=65536, device=dev)
    x = tone(4 * 65536, 0.3, dev)
    ex.run(x, device_loop=True)
    ex.run(x, device_loop=True)
    st = ex.loop_stats()
    # the first chunk runs eagerly, the second is captured, then replays
    assert (st["chunks"], st["piece_calls"], st["replays"]) == (8, 8, 7)
    assert st["captures"] == 1 and st["capture_s"] > 0
    assert st["replay_s"] > 0
    assert st["push_reads"] == 0 and st["push_wait_s"] == 0.0
    g, mm = dmr_graph()
    ex = StreamExecutor(g, chunk_size=480, device=dev)
    ex.run(tone(4 * 480, 0.25, dev), device_loop=True)
    st = ex.loop_stats()
    assert st["chunks"] == st["push_reads"] == 4
    assert st["captures"] == 2 and st["push_wait_s"] > 0
