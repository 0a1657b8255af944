"""The rotator's phases held to the exact phase, on the CPU.

``grtpu_torch.ops.fir.phase_ramp`` reduces ``phase + step * k`` mod 2 pi in
float64 before the one rounding to float32, and ``phase_advance`` carries
the phase in float64, the chunk's advance reduced on the host first (a
``fractions.Fraction`` step of cycles exactly).  Here both are held to the
phase worked out in integers (a rational step) or in long double (a step in
radians) over ramps to 1e7 rad and over 2^17 carried chunks (outputs up to
2^36); the tuner ``FreqXlatingFirFilter`` on the hand kernel's twin to the
matmul path; and config #1 in full (tuner -> wfm_rcv, through
``StreamExecutor``) to the benchmark's plain reference at that cell's
limit, which grtpu's rotator (a float32 ramp, reduced after it is
rounded) fails at a chunk of 65,536.
"""

import json
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks.filter import FreqXlatingFirFilter  # noqa: E402
from grtpu_torch.ops import fir  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "wbfm_rtl2048.file"
TWO_PI_LD = np.longdouble("6.283185307179586476925286766559005768")


def wrapped_gap(got, exact):
    """Largest |got - exact| over the circle, radians (float64 arrays)."""
    d = np.remainder(np.asarray(got, np.float64) - exact + np.pi, 2 * np.pi)
    return float(np.abs(d - np.pi).max())


def exact_turns(p: int, q: int, g0: int, n: int) -> np.ndarray:
    """2 pi ((p g) mod q) / q for g in [g0, g0 + n), the product in
    integers."""
    g = np.arange(n, dtype=np.int64) + g0
    return 2 * np.pi * (((p % q) * (g % q)) % q) / q


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("step", [Fraction(-25, 16), Fraction(-4, 3),
                                  Fraction(2469, 51200)],
                         ids=["config1", "third", "odd"])
def test_phase_ramp_is_exact_over_long_ramps(step):
    """A ramp of 2^20 outputs (to 1e7 rad at the tuner's 9.8 rad an
    output) from a carried phase of 1.25 rad: every phase within 1e-6 rad
    of the exact one, where a float32 ramp is 0.5 rad off."""
    n = 1 << 20
    got = fir.phase_ramp(1.25, step, n, "cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    exact = 1.25 + exact_turns(step.numerator, step.denominator, 0, n)
    assert wrapped_gap(got.numpy(), exact) <= 1e-6
    f32 = (np.float32(1.25) + np.float32(float(step) * 2 * np.pi)
           * np.arange(n, dtype=np.float32))
    assert wrapped_gap(f32, exact) > (1e-3 if step == Fraction(2469, 51200)
                                      else 0.1)


def test_phase_ramp_radians_to_long_double():
    """A step in radians (a float) over 2^20 samples, to 7.7e5 rad: within
    1e-6 rad of the phase worked out in long double from the same step."""
    n, step, ph0 = 1 << 20, 0.7353, 0.5
    got = fir.phase_ramp(torch.tensor(ph0), step, n, "cpu").numpy()
    k = np.arange(n, dtype=np.longdouble)
    exact = np.fmod(np.longdouble(ph0) + np.longdouble(step) * k, TWO_PI_LD)
    assert wrapped_gap(got, exact.astype(np.float64)) <= 1e-6


@pytest.mark.parametrize("step,nout", [(Fraction(-4, 3), 1 << 19),
                                       (Fraction(-25, 16) + Fraction(1, 6000),
                                        65536 + 7)],
                         ids=["third-2^19", "odd-65543"])
def test_carried_phase_stays_exact_over_many_chunks(step, nout):
    """The tuner's carried phase over 2^17 chunks (outputs past 2^36 for
    2^19 a chunk), checked against the integers every 8,192 chunks, and the
    last chunk's ramp from it: each within 1e-6 rad."""
    p, q = step.numerator, step.denominator
    phase = torch.zeros((), dtype=torch.float64)
    chunks = 1 << 17
    for c in range(1, chunks + 1):
        phase = fir.phase_advance(phase, step, nout, "cpu")
        if c % 8192 == 0:
            assert phase.dtype == torch.float64
            assert 0.0 <= float(phase) < 2 * math.pi
            g = c * nout
            exact = 2 * math.pi * float(Fraction((p * g) % q, q))
            assert wrapped_gap(float(phase), exact) <= 1e-6, c
    ramp = fir.phase_ramp(phase, step, 4096, "cpu").numpy()
    g0 = chunks * nout
    assert g0 >= (1 << 36) or nout < (1 << 19)
    exact = np.array([2 * math.pi * float(Fraction((p * g) % q, q))
                      for g in range(g0, g0 + 4096)])
    assert wrapped_gap(ramp, exact) <= 1e-6


def test_carried_phase_in_radians_does_not_drift():
    """dsp.rotate's step (radians a sample) carried over 1,000 chunks of
    16,384: within 1e-6 rad of the long-double phase."""
    step, n = 0.7353, 16384
    phase = torch.tensor(0.5)
    for _ in range(1000):
        phase = fir.phase_advance(phase, step, n, "cpu")
    exact = np.fmod(np.longdouble(0.5) + np.longdouble(step) * 1000 * n,
                    TWO_PI_LD)
    assert wrapped_gap(float(phase), float(exact)) <= 1e-6


def test_position_ramp_is_not_a_phase():
    """FractionalInterpolator's sample positions keep grtpu's float32
    multiply-add and are not reduced."""
    pos = fir.position_ramp(0.25, 1.5, 10000, "cpu")
    k = np.arange(10000, dtype=np.float32).astype(np.float64)
    want = (np.float64(np.float32(0.25)) + np.float64(np.float32(1.5)) * k
            ).astype(np.float32)
    np.testing.assert_array_equal(pos.numpy(), want)
    assert float(pos[-1]) > 2 * math.pi


# ----------------------------------------------------------------- the tuner
def tuner_graph(impl, sig="ccf", center=400e3, fs=2.048e6):
    taps = firdes.low_pass(1.0, fs, 100e3, 50e3)
    g = Graph()
    pin = g.add_input(Port(torch.complex64 if sig[0] == "c" else torch.float32))
    tuner = FreqXlatingFirFilter(8, taps, center, fs, sig, impl=impl)
    g.connect(pin, tuner, g.add_output(Port(torch.complex64)))
    return g, tuner


@pytest.mark.parametrize("device_loop", [False, True], ids=["eager", "loop"])
def test_tuner_on_the_kernel_twin_matches_mxu(device_loop):
    """impl="kernel" (the ccc kernel's twin on the CPU, bf16x3) against
    impl="mxu" (float32 matmul), 4 chunks of 4,096 run twice: within bf16x3's
    1e-4, the carried phases equal."""
    r = np.random.RandomState(5)
    x = torch.from_numpy((r.randn(16384) + 1j * r.randn(16384))
                         .astype(np.complex64))
    outs, phases = {}, {}
    for impl in ("mxu", "kernel"):
        g, tuner = tuner_graph(impl, center=400e3, fs=2.4e6)
        ex = StreamExecutor(g, chunk_size=4096, device="cpu")
        outs[impl] = torch.cat([ex.run(x, device_loop=device_loop)
                                for _ in range(2)])
        phases[impl] = ex.state["blocks"][str(tuner.uid)]
    err = (outs["kernel"] - outs["mxu"]).abs().max() / outs["mxu"].abs().max()
    assert outs["kernel"].shape == (4096,) and float(err) < 1e-4
    assert phases["kernel"].dtype == torch.float64
    assert torch.equal(phases["kernel"], phases["mxu"])
    turns = (-Fraction(400e3) / Fraction(2.4e6) * 2 * 16384) % 1
    assert wrapped_gap(float(phases["kernel"]),
                       2 * math.pi * float(turns)) <= 1e-9


def test_tuner_impl_values():
    for impl, want in (("pallas", "kernel"), ("auto", "mxu"), ("fft", "fft")):
        assert tuner_graph(impl)[1].impl == want
    assert tuner_graph("mxu")[1].impl == FreqXlatingFirFilter(
        8, [1.0, 0.5], 1e3, 8e3).impl
    with pytest.raises(ValueError):
        tuner_graph("kernel", sig="fcf")
    with pytest.raises(ValueError):
        tuner_graph("toeplitz")


def test_tuner_fft_matches_mxu():
    r = np.random.RandomState(6)
    x = torch.from_numpy((r.randn(8192) + 1j * r.randn(8192))
                         .astype(np.complex64))
    outs = {}
    for impl in ("mxu", "fft"):
        outs[impl] = StreamExecutor(tuner_graph(impl)[0], chunk_size=2048,
                                    device="cpu").run(x)
    err = (outs["fft"] - outs["mxu"]).abs().max() / outs["mxu"].abs().max()
    assert float(err) < 1e-5


@pytest.mark.parametrize("device_loop", [False, True], ids=["eager", "loop"])
def test_tuner_opens_its_two_spans(device_loop):
    """grtpu.xlate.fir and grtpu.xlate.rotate, one each a chunk, inside
    the block's span (on the CPU every piece call runs its blocks)."""
    g, tuner = tuner_graph("kernel")
    ex = StreamExecutor(g, chunk_size=2048, device="cpu")
    x = torch.ones(8192, dtype=torch.complex64)
    ex.run(x, device_loop=device_loop)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run(x, device_loop=device_loop)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("grtpu.xlate.fir") == 4
    assert names.count("grtpu.xlate.rotate") == 4


# ------------------------------------------------- config #1 in full
def _cell():
    from radiobench import bench

    _, _, cfg, mix, limits = bench.load_cell(ROOT, CELL)
    return cfg, mix, limits


def chain_audio_err(chunk, requests=3, seed=2 ** 31 + 77):
    """Config #1 through one executor, ``requests`` 2^16-sample requests of
    the benchmark's captures at ``chunk``, under ``device_loop``; the
    numbers its check compares, against the plain reference."""
    from radiobench import bench, signals, traffic
    from radiobench.reference import wbfm_rtl2048 as ref

    cfg, mix, _ = _cell()
    mix = {**mix, "chunk": chunk, "sources": 2, "source_samples": 1 << 16,
           "request_samples": 1 << 16, "prefix_samples": 16384}
    system = bench.module("systems", "wbfm_rtl2048")
    sources = signals.wideband_capture(cfg, mix["source_samples"],
                                       mix["sources"], seed, "cpu")[:, None]
    plan = traffic.Plan(mix, seed)
    ex = StreamExecutor(system.graph(cfg), chunk_size=chunk, device="cpu")
    outputs = {}
    for r in range(requests):
        src, at = plan.slot(r)
        x = sources[src, 0, at:at + mix["request_samples"]]
        outputs[r] = ex.run(x, device_loop=True).numpy().copy()
    return ref.compare(cfg, mix, sources, plan, outputs, requests)


def test_config1_chain_meets_the_cells_limit():
    _, _, limits = _cell()
    numbers = chain_audio_err(16384)
    assert numbers["bad_shape"] == 0
    assert numbers["audio_err"] <= limits["audio_err"]["max"], numbers


def _float32_ramp(phase, step, n, device):
    """grtpu's rotator: ``phase + step * k`` formed and rounded in float32,
    reduced only by the carried phase's wrap."""
    step = float(step) * 2 * math.pi if isinstance(step, Fraction) else step
    k = torch.arange(n, dtype=torch.float32, device=device)
    ph = torch.as_tensor(phase, device=device).to(torch.float32)
    return ph + torch.tensor(step, dtype=torch.float32) * k


def _float32_advance(phase, step, n, device):
    step = float(step) * 2 * math.pi if isinstance(step, Fraction) else step
    ph = torch.as_tensor(phase, device=device).to(torch.float32)
    return torch.remainder(ph + torch.tensor(step * n, dtype=torch.float32),
                           2 * math.pi)


def test_float32_rotator_fails_the_cells_limit(monkeypatch):
    """The fault this guards: grtpu's float32 ramp put back, at a chunk of
    65,536 (a ramp of 8,192 outputs, to 8e4 rad), misses the limit that
    the exact rotator meets."""
    _, _, limits = _cell()
    monkeypatch.setattr(fir, "phase_ramp", _float32_ramp)
    monkeypatch.setattr(fir, "phase_advance", _float32_advance)
    numbers = chain_audio_err(65536, requests=2)
    assert numbers["bad_shape"] == 0
    assert numbers["audio_err"] > limits["audio_err"]["max"], numbers


def test_limits_file_is_the_cells():
    limits = json.loads((ROOT / "radiobench" / "limits" / f"{CELL}.json")
                        .read_text())
    assert set(limits) == {"audio_err", "bad_shape"}
