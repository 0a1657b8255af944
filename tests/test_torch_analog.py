"""grtpu_torch.blocks.analog against grtpu.blocks.analog on the CPU.

Every block runs as a graph through both packages' executors on the same
numpy-seeded input, at two chunk sizes where state is carried.  Tolerances:
1e-5 relative to the reference's peak for elementwise and matmul paths;
gated outputs (squelches) identical where the averaged power is not within
rounding of the threshold; the sequential loops (AGC, PLL) 1e-4 absolute on
unit-scale signals over 2,048 steps (each step rounds in float32 in both
packages; XLA fuses some multiply-adds that torch rounds twice); the VCO's
phase is a float32 prefix sum, with the bound stated at its test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _exact_rotator  # noqa: E402
import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import analog as ja  # noqa: E402
from grtpu_torch.blocks import analog as ta  # noqa: E402

N = 4096


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def cnoise(n, seed, scale=1.0):
    r = np.random.RandomState(seed)
    return (scale * (r.randn(n) + 1j * r.randn(n))).astype(np.complex64)


def run_block(kind, blk, inputs, chunk, steps=None):
    pkg = grtpu if kind == "j" else grtpu_torch
    g = pkg.Graph()
    for i, port in enumerate(blk.in_ports):
        g.connect(g.add_input(port), (blk, i))
    for i, port in enumerate(blk.out_ports):
        g.connect((blk, i), g.add_output(port))
    kw = {} if kind == "j" else {"device": "cpu"}
    ex = pkg.StreamExecutor(g, chunk_size=chunk, **kw)
    if steps is not None:
        y = ex.run(steps=steps)
    else:
        y = ex.run(*[jnp.asarray(x) if kind == "j" else x for x in inputs])
    return (np.asarray(y) if kind == "j" else y.numpy()), ex


def both(make, inputs, chunk, steps=None):
    ref, jex = run_block("j", make(ja, jnp), inputs, chunk, steps)
    got, tex = run_block("t", make(ta, torch), inputs, chunk, steps)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    return ref, got, jex, tex


def states_close(jex, tex, atol):
    """Every carried block state agrees (the executors list their blocks in
    the same topological order)."""
    import jax

    js = [np.asarray(v) for b in jex.order
          for v in jax.tree_util.tree_leaves(jex.state["blocks"][str(b.uid)])]
    ts = []
    for b in tex.order:
        st = tex.state["blocks"][str(b.uid)]
        ts += [v.numpy() for v in (st if isinstance(st, tuple) else (st,))]
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b, a, atol=atol)


def test_phase_modulator():
    x = np.random.RandomState(0).randn(N).astype(np.float32)
    ref, got, _, _ = both(lambda m, lib: m.PhaseModulator(1.3), [x], 1024)
    assert rel(got, ref) < 1e-5


WAVEFORMS = [("cos", np.float32), ("sin", np.float32), ("square", np.float32),
             ("triangle", np.float32), ("sawtooth", np.float32),
             ("const", np.float32), ("complex", np.complex64),
             ("cos", np.complex64)]


@pytest.mark.parametrize("chunk", [1024, 4096])
@pytest.mark.parametrize("waveform,dtype", WAVEFORMS,
                         ids=[f"{w}-{np.dtype(d).name}" for w, d in WAVEFORMS])
def test_sig_source(waveform, dtype, chunk, monkeypatch):
    """The NCO's phases reduced mod 2 pi before they are rounded, the phase
    carried and wrapped each chunk: held to grtpu with its float32 ramp (to
    660 rad at chunk 4,096, where a float32 step is 6e-5 rad) reduced
    before rounding as well (``_exact_rotator``), the waveforms agree to
    1e-5 over 16,384 samples (the discontinuous ones away from their edges,
    where a last-bit phase difference would flip a whole step) and the
    carried phase to 1e-5 rad."""
    _exact_rotator.install(monkeypatch)
    steps = 16384 // chunk
    ref, got, jex, tex = both(
        lambda m, lib: m.SigSource(48000.0, waveform, 1234.5, 0.8, 0.1,
                                   dtype=dtype), [], chunk, steps=steps)
    diff = np.abs(got - ref)
    if waveform in ("square", "sawtooth"):
        assert (diff > 1e-5).mean() < 1e-3
    else:
        assert diff.max() < 1e-5
    states_close(jex, tex, 1e-5)


def test_sig_source_rejects_unknown_waveform():
    with pytest.raises(ValueError):
        ta.SigSource(48000.0, "noise", 100.0)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32],
                         ids=["cc", "ff"])
@pytest.mark.parametrize("name,kw", [
    ("Agc", dict(rate=1e-3, reference=1.0, gain=0.5)),
    ("Agc", dict(rate=5e-3, reference=0.7, gain=2.0, max_gain=2.5)),
    ("Agc2", dict(attack_rate=1e-1, decay_rate=1e-2, reference=1.0)),
    ("Agc2", dict(attack_rate=5e-2, decay_rate=5e-3, gain=0.2, max_gain=3.0)),
], ids=["agc", "agc-maxgain", "agc2", "agc2-maxgain"])
def test_agc_loops(name, kw, dtype):
    x = cnoise(2048, 1, 0.6)
    x = x * (1 + 0.5 * np.sin(np.arange(2048) * 0.01)).astype(np.float32)
    if dtype == np.float32:
        x = np.ascontiguousarray(x.real)
    ref, got, jex, tex = both(
        lambda m, lib: getattr(m, name)(dtype=dtype, **kw), [x], 1024)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    states_close(jex, tex, 1e-4)


@pytest.mark.parametrize("name", ["PllRefout", "PllFreqdet",
                                  "PllCarrierTracking"])
def test_pll_loops(name):
    """A tone at 0.2 rad/sample in noise: the loop locks, and the two
    packages' outputs and carried (phase, freq) agree."""
    n = 2048
    x = (np.exp(1j * (0.2 * np.arange(n) + 0.7)) + cnoise(n, 2, 0.05)
         ).astype(np.complex64)
    ref, got, jex, tex = both(
        lambda m, lib: getattr(m, name)(0.05, 0.5, -0.5), [x], 1024)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    states_close(jex, tex, 1e-4)
    if name == "PllFreqdet":
        assert abs(got[-200:].mean() - 0.2) < 0.01


@pytest.mark.parametrize("chunk", [1024, 4096])
def test_feed_forward_agc(chunk):
    x = cnoise(N, 3) * np.linspace(0.1, 2.0, N).astype(np.float32)
    ref, got, _, _ = both(lambda m, lib: m.FeedForwardAgc(64, 0.9), [x], chunk)
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("alpha", [1e-2, 0.3], ids=["slow-pole", "fast-pole"])
@pytest.mark.parametrize("dtype", [np.complex64, np.float32],
                         ids=["cf", "ff"])
def test_rms(dtype, alpha):
    """alpha = 1e-2 takes the single-pole filter's log-depth scan, 0.3 its
    truncated FIR: grtpu's scan-vs-FIR bound, 1e-5 absolute."""
    x = cnoise(N, 4)
    if dtype == np.float32:
        x = np.ascontiguousarray(x.real)
    ref, got, jex, tex = both(lambda m, lib: m.Rms(alpha, dtype=dtype), [x],
                              1024)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    states_close(jex, tex, 1e-5)


def _gated_input(seed):
    """Noise whose level steps well below and well above the threshold."""
    x = cnoise(N, seed)
    level = np.repeat(np.array([0.001, 1.0, 0.001, 0.5], np.float32), N // 4)
    return x * level


@pytest.mark.parametrize("chunk", [1024, 4096])
@pytest.mark.parametrize("name,dtype", [("SimpleSquelch", np.complex64),
                                        ("PwrSquelch", np.complex64),
                                        ("PwrSquelch", np.float32)],
                         ids=["simple", "pwr-cc", "pwr-ff"])
def test_squelches(name, dtype, chunk):
    """The gate (open where the averaged power reaches the threshold) is
    identical except within a few samples of each crossing, where the two
    averages differ in the last bits; the passed samples are untouched."""
    x = _gated_input(5)
    if dtype == np.float32:
        x = np.ascontiguousarray(x.real)
    kw = {} if name == "SimpleSquelch" else {"dtype": dtype}
    ref, got, jex, tex = both(
        lambda m, lib: getattr(m, name)(-20.0, 0.05, **kw), [x], chunk)
    gate_ref, gate_got = ref != 0, got != 0
    assert (gate_ref != gate_got).sum() <= 4
    assert 0.3 < gate_got.mean() < 0.7
    same = gate_ref & gate_got
    np.testing.assert_array_equal(got[same], x[same])
    states_close(jex, tex, 1e-5)


def test_probe_avg_mag_sqrd():
    x = _gated_input(6)
    levels = []
    for kind, mod, pkg in (("j", ja, grtpu), ("t", ta, grtpu_torch)):
        probe = mod.ProbeAvgMagSqrd(-10.0, 0.01)
        assert probe.level() == 0.0
        g = pkg.Graph()
        g.connect(g.add_input(probe.in_ports[0]), probe)
        kw = {} if kind == "j" else {"device": "cpu"}
        ex = pkg.StreamExecutor(g, chunk_size=1024, **kw)
        ex.run(jnp.asarray(x) if kind == "j" else x)
        levels.append((probe.level(), bool(probe.unmuted()),
                       float(np.asarray(ex.state["blocks"][str(probe.uid)]))))
    assert abs(levels[0][0] - levels[1][0]) < 1e-6
    assert levels[0][1] == levels[1][1]
    assert abs(levels[0][2] - levels[1][2]) < 1e-5


def test_fm_det():
    x = np.exp(1j * np.cumsum(0.3 * np.sin(np.arange(N) * 0.01))
               ).astype(np.complex64)
    ref, got, _, _ = both(lambda m, lib: m.FmDet(256e3, -75e3, 75e3), [x],
                          1024)
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("chunk", [1024, 4096])
def test_vco(chunk):
    """The phase is a float32 prefix sum over each chunk (torch sums it in
    float64 on a CPU, XLA in float32): 5e-4 absolute at 4,096-sample chunks
    of |dphi| < 0.4, the carried phase likewise (mod 2 pi)."""
    x = (0.8 * np.sin(np.arange(N) * 0.003)).astype(np.float32)
    ref, got, jex, tex = both(lambda m, lib: m.Vco(48000.0, 24000.0, 0.9),
                              [x], chunk)
    np.testing.assert_allclose(got, ref, atol=5e-4)
    jp = float(np.asarray(jex.state["blocks"][str(jex.order[0].uid)]))
    tp = float(tex.state["blocks"][str(tex.order[0].uid)])
    d = abs(jp - tp)
    assert min(d, 2 * np.pi - d) < 5e-4


# -------------------------------------------------------------- checkpoints
STATEFUL = {
    "SigSource": (lambda m, lib: m.SigSource(48000.0, "cos", 1000.0), None),
    "Vco": (lambda m, lib: m.Vco(48000.0, 24000.0), "f"),
    "Rms": (lambda m, lib: m.Rms(0.05), "c"),
    "SimpleSquelch": (lambda m, lib: m.SimpleSquelch(-20.0, 0.05), "c"),
    "PwrSquelch": (lambda m, lib: m.PwrSquelch(-20.0, 0.05), "c"),
    "FeedForwardAgc": (lambda m, lib: m.FeedForwardAgc(32), "c"),
    "Agc": (lambda m, lib: m.Agc(1e-2), "c"),
    "Agc2": (lambda m, lib: m.Agc2(), "c"),
    "PllRefout": (lambda m, lib: m.PllRefout(0.05, 0.5, -0.5), "c"),
    "FrequencyModulator": (lambda m, lib: m.FrequencyModulator(0.3), "f"),
}


@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")],
                         ids=["grtpu-to-port", "port-to-grtpu"])
@pytest.mark.parametrize("name", list(STATEFUL))
def test_state_moves_between_packages(tmp_path, name, writer, reader):
    """Each stateful block, stopped after one chunk in one package and
    resumed in the other under grtpu's leaf paths, equals the uninterrupted
    run."""
    make, kind = STATEFUL[name]
    chunk = 512
    x = None
    if kind == "c":
        x = cnoise(2 * chunk, 7, 0.5)
    elif kind == "f":
        x = (0.5 * np.sin(np.arange(2 * chunk) * 0.01)).astype(np.float32)
    mods = {"j": (ja, jnp), "t": (ta, torch)}

    def go(k, inputs, steps, load=None, save=None):
        pkg = grtpu if k == "j" else grtpu_torch
        blk = make(*mods[k])
        g = pkg.Graph()
        if blk.in_ports:
            g.connect(g.add_input(blk.in_ports[0]), blk)
        g.connect(blk, g.add_output(blk.out_ports[0]))
        kw = {} if k == "j" else {"device": "cpu"}
        ex = pkg.StreamExecutor(g, chunk_size=chunk, **kw)
        if load:
            ex.load_checkpoint(load)
        if inputs is None:
            y = ex.run(steps=steps)
        else:
            y = ex.run(jnp.asarray(inputs) if k == "j" else inputs)
        if save:
            ex.save_checkpoint(save)
        return np.asarray(y) if k == "j" else y.numpy()

    path = str(tmp_path / "state.npz")
    full = go(writer, x, 2)
    go(writer, None if x is None else x[:chunk], 1, save=path)
    tail = go(reader, None if x is None else x[chunk:], 1, load=path)
    np.testing.assert_allclose(tail, full[chunk:], atol=2e-4)
