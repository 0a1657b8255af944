"""grtpu_torch's convert, gengen, stream and filter blocks against grtpu on
the CPU.

Every block runs as a graph through both packages' executors on the same
numpy-seeded input (two chunk sizes for the chunk-sensitive ones).
Tolerances: elementwise float ops and float32 matmul paths 1e-5 relative to
the reference's peak; integer / packed / mapped / gated outputs identical;
prefix-sum blocks (MovingAverage, DcBlocker) an absolute bound stated at the
test, because torch's CPU ``cumsum`` accumulates float32 in float64 and
XLA's does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import convert as jconv, filter as jfilt  # noqa: E402
from grtpu.blocks import gengen as jgen, stream as jstream  # noqa: E402
from grtpu_torch.blocks import convert as tconv, filter as tfilt  # noqa: E402
from grtpu_torch.blocks import gengen as tgen, stream as tstream  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

N = 2048
MODS = {"j": dict(conv=jconv, filt=jfilt, gen=jgen, stream=jstream),
        "t": dict(conv=tconv, filt=tfilt, gen=tgen, stream=tstream)}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def data(kind, n=N, seed=0, vlen=1):
    r = np.random.RandomState(seed)
    shape = (n,) if vlen == 1 else (n, vlen)
    if kind == "c":
        return (r.randn(*shape) + 1j * r.randn(*shape)).astype(np.complex64)
    if kind == "f":
        return r.randn(*shape).astype(np.float32)
    if kind == "b":
        return r.randint(0, 256, shape).astype(np.uint8)
    if kind == "bit":
        return r.randint(0, 2, shape).astype(np.uint8)
    if kind == "s":
        return r.randint(-32768, 32768, shape).astype(np.int16)
    if kind == "i":
        return r.randint(-2 ** 31, 2 ** 31 - 1, shape).astype(np.int32)
    if kind == "i8":
        return r.randint(-128, 128, shape).astype(np.int8)
    raise KeyError(kind)


def run_block(kind, blk, inputs, chunk):
    """One block between input and output pads; returns a tuple of numpy
    outputs."""
    pkg = grtpu if kind == "j" else grtpu_torch
    g = pkg.Graph()
    for i, port in enumerate(blk.in_ports):
        g.connect(g.add_input(port), (blk, i))
    for i, port in enumerate(blk.out_ports):
        g.connect((blk, i), g.add_output(port))
    if kind == "j":
        y = pkg.StreamExecutor(g, chunk_size=chunk).run(
            *[jnp.asarray(x) for x in inputs])
        y = y if isinstance(y, tuple) else (y,)
        return tuple(np.asarray(v) for v in y)
    y = pkg.StreamExecutor(g, chunk_size=chunk, device="cpu").run(*inputs)
    y = y if isinstance(y, tuple) else (y,)
    return tuple(v.numpy() for v in y)


def check(make, inputs, chunk=512, tol=1e-5, exact=False, atol=None,
          same_dtype=True):
    ref = run_block("j", make(MODS["j"], jnp), inputs, chunk)
    got = run_block("t", make(MODS["t"], torch), inputs, chunk)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        if same_dtype:
            assert g.dtype == r.dtype, (g.dtype, r.dtype)
        if exact:
            np.testing.assert_array_equal(g, r)
        elif atol is not None:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0)
        else:
            assert rel(g, r) < tol
    return got


# ------------------------------------------------------------------ convert
C2F = ["ComplexToFloat", "ComplexToReal", "ComplexToImag", "ComplexToMag",
       "ComplexToMagSquared", "ComplexToArg", "Conjugate"]


@pytest.mark.parametrize("name", C2F)
def test_convert_complex_blocks(name):
    check(lambda m, lib: getattr(m["conv"], name)(), [data("c")])


@pytest.mark.parametrize("nin", [1, 2])
def test_float_to_complex(nin):
    check(lambda m, lib: m["conv"].FloatToComplex(nin),
          [data("f", seed=i) for i in range(nin)])


def _rails(scale):
    """Ties (round half to even), values at and past both rails."""
    ties = np.arange(-6, 7, dtype=np.float32) + 0.5
    big = np.array([32766.5, 32767.4, 32767.5, 32768.0, 4e4, -32768.5,
                    -32769.0, -4e4, 126.5, 127.5, 128.0, -128.5, -129.0,
                    254.5, 255.5, 256.0, -0.5, -1.0, 2.5e9, -2.5e9, 2147483520.0,
                    2147483648.0, -2147483648.0], np.float32)
    x = np.concatenate([ties, big, data("f", 2048 - 36, seed=3) * 300])
    return (x / scale).astype(np.float32)


@pytest.mark.parametrize("name,scale", [
    ("FloatToShort", 1.0), ("FloatToShort", 4.0), ("FloatToChar", 1.0),
    ("FloatToChar", 0.5), ("FloatToUChar", None), ("FloatToInt", 1.0),
    ("FloatToInt", 1000.0), ("FloatToCharSigned", None)])
def test_float_to_int_converters_round_and_saturate(name, scale):
    """Rounding mode and saturation per class: identical integers at +-0.5
    and at the rails."""
    x = _rails(scale or 1.0)
    args = () if scale is None else (scale,)
    got = check(lambda m, lib: getattr(m["conv"], name)(*args), [x],
                exact=True)[0]
    if name == "FloatToShort" and scale == 1.0:
        assert got[:13].tolist() == [-6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6, 6]
        assert got.max() == 32767 and got.min() == -32768


@pytest.mark.parametrize("name,kind,scale", [
    ("ShortToFloat", "s", 1 / 32768), ("CharToFloat", "i8", 0.5),
    ("UCharToFloat", "b", None), ("IntToFloat", "i", 1e-3),
    ("CharToFloatSigned", "b", None)])
def test_int_to_float_converters(name, kind, scale):
    args = () if scale is None else (scale,)
    check(lambda m, lib: getattr(m["conv"], name)(*args), [data(kind)],
          tol=1e-7)


def test_interleaved_short_round_trip():
    check(lambda m, lib: m["conv"].InterleavedShortToComplex(1 / 1024),
          [data("s")], tol=1e-7)
    x = data("c", seed=5) * 20000
    check(lambda m, lib: m["conv"].ComplexToInterleavedShort(1.5), [x],
          exact=True)


@pytest.mark.parametrize("src,dst", [("f", "i"), ("s", "f"), ("b", "i"),
                                     ("i", "s"), ("f", "c")])
def test_cast(src, dst):
    dt = {"f": np.float32, "i": np.int32, "s": np.int16, "b": np.uint8,
          "c": np.complex64}
    x = data(src)
    if src == "f":
        x = x * 100
    check(lambda m, lib: m["conv"].Cast(dt[src], dt[dst]), [x], exact=True)


# ------------------------------------------------------------------- gengen
@pytest.mark.parametrize("name,kind,nin", [
    ("Add", "f", 2), ("Add", "c", 3), ("Sub", "f", 2), ("Sub", "s", 2),
    ("Multiply", "c", 2), ("Multiply", "f", 3), ("Divide", "f", 2),
    ("Divide", "c", 2), ("And", "b", 2), ("Or", "s", 2), ("Xor", "i", 3)])
def test_nary_ops(name, kind, nin):
    dt = {"f": np.float32, "c": np.complex64, "b": np.uint8, "s": np.int16,
          "i": np.int32}[kind]
    ins = [data(kind, seed=10 + i) for i in range(nin)]
    if name == "Divide":
        ins[1] = ins[1] + np.asarray(3.0, dt)
    check(lambda m, lib: getattr(m["gen"], name)(dtype=dt, nin=nin), ins,
          exact=kind in "bsi")


def test_nary_vector_ports():
    ins = [data("f", N, seed=i, vlen=4) for i in range(2)]
    check(lambda m, lib: m["gen"].Add(dtype=np.float32, nin=2, vlen=4), ins)


@pytest.mark.parametrize("kind", ["b", "s", "i"])
def test_not_and_and_const(kind):
    dt = {"b": np.uint8, "s": np.int16, "i": np.int32}[kind]
    check(lambda m, lib: m["gen"].Not(dtype=dt), [data(kind)], exact=True)
    check(lambda m, lib: m["gen"].AndConst(0x5A, dtype=dt), [data(kind)],
          exact=True)


@pytest.mark.parametrize("kind", ["f", "c", "s"])
def test_integrate(kind):
    dt = {"f": np.float32, "c": np.complex64, "s": np.int16}[kind]
    x = data(kind)
    if kind == "s":
        x = (x // 64).astype(np.int16)
    # grtpu's sum widens int16 to int32 past its declared port; the port
    # keeps the declared dtype, the values are the same
    got = check(lambda m, lib: m["gen"].Integrate(8, dtype=dt), [x],
                exact=kind == "s", same_dtype=kind != "s")[0]
    assert got.dtype == dt


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("kind,length", [("f", 16), ("c", 7), ("i", 5)])
def test_moving_average(kind, length, chunk):
    """A prefix-sum difference over chunk + length - 1 samples: float32
    bound 2e-4 absolute at 1,024 unit-variance samples; integers exact."""
    dt = {"f": np.float32, "c": np.complex64, "i": np.int32}[kind]
    x = data(kind) if kind != "i" else (data("s").astype(np.int32))
    check(lambda m, lib: m["gen"].MovingAverage(length, 0.25 if kind != "i"
                                                else 3, dtype=dt),
          [x], chunk=chunk, exact=kind == "i", atol=2e-4)


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("kind", ["f", "c"])
def test_sample_and_hold(kind, chunk):
    """The port's closed form (running maximum of the set indices) against
    grtpu's scan: identical values, the carried held value too."""
    dt = {"f": np.float32, "c": np.complex64}[kind]
    ctrl = (np.random.RandomState(4).rand(N) < 0.02).astype(np.uint8)
    ctrl[:40] = 0          # the carried initial value shows first
    ctrl[1024:1400] = 0    # a gap across a chunk boundary
    check(lambda m, lib: m["gen"].SampleAndHold(dtype=dt),
          [data(kind, seed=6), ctrl], chunk=chunk, exact=True)


@pytest.mark.parametrize("chunk", [512, 1024])
def test_peak_detector(chunk):
    """Bursts on a noise floor: the same flags in the same places, also for
    a burst that straddles a chunk boundary."""
    r = np.random.RandomState(7)
    x = 0.1 * np.abs(r.randn(N)).astype(np.float32) + 1.0
    for start in (200, 500, 1000, 1500):   # 1000..1060 straddles 1024
        x[start:start + 60] += 4.0 * np.hanning(60).astype(np.float32)
    got = check(lambda m, lib: m["gen"].PeakDetector(alpha=0.01), [x],
                chunk=chunk, exact=True)[0]
    assert 2 <= got.sum() <= 8


@pytest.mark.parametrize("name", ["Argmax", "Max"])
def test_argmax_max(name):
    x = data("f", 512, seed=8, vlen=16)
    x[5, 3] = x[5, 9] = 9.0     # a tie: the first index wins in both
    got = check(lambda m, lib: getattr(m["gen"], name)(16), [x], chunk=128,
                exact=True)[0]
    if name == "Argmax":
        assert got[5] == 3


@pytest.mark.parametrize("muted", [False, True])
def test_mute(muted):
    check(lambda m, lib: m["gen"].Mute(muted), [data("f")], exact=True)


def test_mute_setter_invalidates_executor():
    blk = tgen.Mute(False)
    g = grtpu_torch.Graph()
    g.connect(g.add_input(blk.in_ports[0]), blk, g.add_output(blk.out_ports[0]))
    ex = grtpu_torch.StreamExecutor(g, chunk_size=64, device="cpu")
    ex.run(data("f", 64))
    blk.set_mute(True)
    with pytest.raises(RuntimeError):
        ex.run(data("f", 64))


@pytest.mark.parametrize("dimension", [1, 2])
def test_chunks_to_symbols(dimension):
    table = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    x = data("b") % (8 // dimension)
    check(lambda m, lib: m["gen"].ChunksToSymbols(table, dimension=dimension),
          [x], exact=True)
    ftable = np.linspace(-1, 1, 4).astype(np.float32)
    check(lambda m, lib: m["gen"].ChunksToSymbols(
        ftable, out_dtype=np.float32), [data("b") % 4], exact=True)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_packed_unpacked(k):
    check(lambda m, lib: m["gen"].PackedToUnpacked(k), [data("b")], exact=True)
    x = data("b", N * 4) % (1 << k)
    check(lambda m, lib: m["gen"].UnpackedToPacked(k), [x[:N * 8 // k]
                                                        if k < 4 else x[:N]],
          exact=True)


@pytest.mark.parametrize("k", [3, 8])
def test_pack_unpack_k_bits(k):
    check(lambda m, lib: m["gen"].PackKBits(k), [data("bit", 512 * k)],
          chunk=64 * k, exact=True)
    check(lambda m, lib: m["gen"].UnpackKBits(k), [data("b")], exact=True)


def test_map_bb():
    table = np.random.RandomState(9).permutation(256).astype(np.uint8)
    check(lambda m, lib: m["gen"].MapBB(table), [data("b")], exact=True)


def _source_run(kind, src, steps, chunk=256):
    pkg = grtpu if kind == "j" else grtpu_torch
    g = pkg.Graph()
    g.connect(src, g.add_output(src.out_ports[0]))
    kw = {} if kind == "j" else {"device": "cpu"}
    y = pkg.StreamExecutor(g, chunk_size=chunk, **kw).run(steps=steps)
    return np.asarray(y) if kind == "j" else y.numpy()


@pytest.mark.parametrize("kind,vlen", [("f", 1), ("c", 4)])
def test_null_source(kind, vlen):
    dt = {"f": np.float32, "c": np.complex64}[kind]
    ref = _source_run("j", jgen.NullSource(dt, vlen), 3)
    got = _source_run("t", tgen.NullSource(dt, vlen), 3)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert not got.any()


@pytest.mark.parametrize("kind", ["gaussian", "uniform"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64],
                         ids=["float", "complex"])
def test_noise_source_statistics(kind, dtype):
    """grtpu draws from a JAX PRNG key, the port from a torch.Generator: the
    two streams cannot be equal, so the port is held to the distribution at
    2^16 samples (mean, variance, the complex amplitude/sqrt(2) split) and
    to reproducibility from its seed."""
    amp = 0.7
    y = _source_run("t", tgen.NoiseSource(kind, amp, seed=5, dtype=dtype),
                    16, chunk=4096)
    ref = _source_run("j", jgen.NoiseSource(kind, amp, seed=5, dtype=dtype),
                      16, chunk=4096)
    assert y.shape == ref.shape == (1 << 16,) and y.dtype == ref.dtype
    parts = [y.real, y.imag] if np.iscomplexobj(y) else [y]
    rparts = [ref.real, ref.imag] if np.iscomplexobj(ref) else [ref]
    for p, rp in zip(parts, rparts):
        assert abs(p.mean()) < 0.01
        want = rp.var()
        if kind == "gaussian":
            theory = amp ** 2 / (2 if np.iscomplexobj(y) else 1)
        else:
            theory = amp ** 2 / 3
            assert np.abs(p).max() <= amp
        assert abs(want / theory - 1) < 0.03     # grtpu meets the same law
        assert abs(p.var() / theory - 1) < 0.03
    if np.iscomplexobj(y):
        assert abs(np.mean(y.real * y.imag)) < 0.01
    again = _source_run("t", tgen.NoiseSource(kind, amp, seed=5, dtype=dtype),
                        16, chunk=4096)
    np.testing.assert_array_equal(again, y)
    other = _source_run("t", tgen.NoiseSource(kind, amp, seed=6, dtype=dtype),
                        16, chunk=4096)
    assert not np.array_equal(other, y)


def test_noise_source_rejects_unknown_kind():
    with pytest.raises(ValueError):
        tgen.NoiseSource("laplace")


def test_probe_signal_and_suffix_factories():
    x = data("f")
    for kind, gen, pkg in (("j", jgen, grtpu), ("t", tgen, grtpu_torch)):
        probe = gen.ProbeSignal()
        g = pkg.Graph()
        g.connect(g.add_input(probe.in_ports[0]), probe)
        kw = {} if kind == "j" else {"device": "cpu"}
        pkg.StreamExecutor(g, chunk_size=512, **kw).run(
            jnp.asarray(x) if kind == "j" else x)
        assert float(probe.level()) == float(x[-1])
    names = [n for n in dir(jgen) if n[-3:-2] == "_" or n.startswith(
        ("vector_s", "null_s", "noise_source_"))]
    factories = [n for n in names if callable(getattr(jgen, n))
                 and n[0].islower() and not n.startswith("_")
                 and n not in ("functools", "to_numpy")]
    assert len(factories) >= 55
    for n in factories:
        assert hasattr(tgen, n), n
    blk = tgen.multiply_const_cc(2j)
    assert blk.in_ports[0].dtype == torch.complex64


# ------------------------------------------------------------------- stream
STREAM = {
    "Copy": (lambda m, lib: m["stream"].Copy(np.complex64), "c", 1),
    "Throttle": (lambda m, lib: m["stream"].Throttle(np.float32), "f", 1),
    "StreamToVector": (lambda m, lib: m["stream"].StreamToVector(
        np.float32, 8), "f", 1),
    "VectorToStream": (lambda m, lib: m["stream"].VectorToStream(
        np.complex64, 4), "c", 4),
    "KeepOneInN": (lambda m, lib: m["stream"].KeepOneInN(4, np.float32),
                   "f", 1),
    "KeepOneInN_vec": (lambda m, lib: m["stream"].KeepOneInN(
        4, np.float32, vlen=3), "f", 3),
    "Repeat": (lambda m, lib: m["stream"].Repeat(3, np.int16), "s", 1),
    "Delay": (lambda m, lib: m["stream"].Delay(37, np.complex64), "c", 1),
    "Delay_vec": (lambda m, lib: m["stream"].Delay(5, np.float32, vlen=2),
                  "f", 2),
    "Delay0": (lambda m, lib: m["stream"].Delay(0, np.float32), "f", 1),
    "SkipHead": (lambda m, lib: m["stream"].SkipHead(700, np.float32), "f", 1),
    "Head": (lambda m, lib: m["stream"].Head(700, np.float32), "f", 1),
    "Head_vec": (lambda m, lib: m["stream"].Head(300, np.float32, vlen=2),
                 "f", 2),
    "Deinterleave": (lambda m, lib: m["stream"].Deinterleave(4, np.float32),
                     "f", 1),
    "StreamToStreams": (lambda m, lib: m["stream"].StreamToStreams(
        2, np.int16), "s", 1),
    "VectorToStreams": (lambda m, lib: m["stream"].VectorToStreams(
        np.float32, 3), "f", 3),
}


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("name", list(STREAM))
def test_stream_blocks(name, chunk):
    make, kind, vlen = STREAM[name]
    check(make, [data(kind, vlen=vlen)], chunk=chunk, exact=True)


@pytest.mark.parametrize("name,nin", [("Interleave", 3), ("StreamsToStream", 2),
                                      ("StreamMux", 2), ("StreamsToVector", 4)])
def test_stream_joins(name, nin):
    ins = [data("f", seed=20 + i) for i in range(nin)]
    if name == "StreamMux":
        make = lambda m, lib: m["stream"].StreamMux([4] * nin, np.float32)  # noqa: E731
    elif name == "StreamsToVector":
        make = lambda m, lib: m["stream"].StreamsToVector(np.float32, nin)  # noqa: E731
    else:
        make = lambda m, lib: getattr(m["stream"], name)(nin, np.float32)  # noqa: E731
    check(make, ins, exact=True)


def test_stream_mux_rejects_unequal_runs():
    with pytest.raises(NotImplementedError):
        tstream.StreamMux([2, 3])


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("name,n_keep", [("SkipHead", 700), ("Head", 700),
                                         ("Head", 5000)])
def test_compact_head_and_skiphead_are_variable_rate(name, n_keep, chunk):
    """compact=True rides the executor's variable-rate FIFO: the stream
    really is shorter, and equal to grtpu's."""
    x = data("f")
    got = check(lambda m, lib: getattr(m["stream"], name)(
        n_keep, np.float32, compact=True), [x], chunk=chunk, exact=True)[0]
    want = x[n_keep:] if name == "SkipHead" else x[:n_keep]
    # whole emissions only: what is left in the FIFO stays in the state
    assert len(got) <= len(want) and len(want) - len(got) < chunk
    np.testing.assert_array_equal(got, want[:len(got)])


# ------------------------------------------------------------------- filter
@pytest.mark.parametrize("chunk", [1176, 2352])
@pytest.mark.parametrize("L,M,sig", [(3, 2, "fff"), (2, 3, "ccf"),
                                     (160, 147, "fff"), (4, 6, "ccc")])
def test_rational_resampler(L, M, sig, chunk):
    taps = None
    if sig == "ccc":
        taps = (firdes.low_pass(2, 2, 0.15, 0.1)
                * np.exp(0.3j * np.arange(len(firdes.low_pass(
                    2, 2, 0.15, 0.1))))).astype(np.complex64)
    x = data("c" if sig[0] == "c" else "f", 2 * 2352)
    check(lambda m, lib: m["filt"].RationalResampler(L, M, taps, sig), [x],
          chunk=chunk)


def test_rational_resampler_design_identical():
    for L, M in ((3, 2), (2, 3), (160, 147)):
        np.testing.assert_array_equal(
            jfilt.RationalResampler._design(L, M, 0.4),
            tfilt.RationalResampler._design(L, M, 0.4))
    with pytest.raises(ValueError):
        tfilt.RationalResampler(3, 2, fractional_bw=0.6)


@pytest.mark.parametrize("chunk", [512, 2048])
@pytest.mark.parametrize("sig,decim", [("ccf", 8), ("ccc", 4), ("fcf", 2),
                                       ("scf", 4)])
def test_freq_xlating_fir_filter_block(sig, decim, chunk):
    """The tuner as a block: the rotator's phase is carried across chunks,
    so the two chunk sizes also agree with each other."""
    taps = firdes.low_pass(1.0, 2.048e6, 100e3, 50e3)
    if sig == "ccc":
        taps = (taps * np.exp(0.1j * np.arange(len(taps)))).astype(np.complex64)
    x = data({"c": "c", "f": "f", "s": "s"}[sig[0]], 8192)
    if sig[0] == "s":
        x = (x // 256).astype(np.int16)
    got = check(lambda m, lib: m["filt"].FreqXlatingFirFilter(
        decim, taps, 400e3, 2.048e6, sig), [x], chunk=chunk)[0]
    assert got.dtype == np.complex64 and got.shape == (8192 // decim,)


@pytest.mark.parametrize("chunk", [256, 1024])
@pytest.mark.parametrize("name", ["Hilbert", "FilterDelay"])
def test_hilbert_and_filter_delay(name, chunk):
    taps = firdes.hilbert(31)
    make = (lambda m, lib: m["filt"].Hilbert(65)) if name == "Hilbert" else \
        (lambda m, lib: m["filt"].FilterDelay(taps))
    check(make, [data("f")], chunk=chunk)


@pytest.mark.parametrize("chunk", [512, 1024])
@pytest.mark.parametrize("kind,long_form,d", [("f", True, 32), ("f", False, 32),
                                              ("c", True, 16),
                                              ("f", False, 1024)])
def test_dc_blocker_block(kind, long_form, d, chunk):
    """Prefix sums over chunk + history samples of input with a DC of 2:
    absolute bound 5e-4 (float32 running sums reach ~1e4 at AmDemod's
    d=1024; one float32 step there is 1e-3, divided by d)."""
    dt = {"f": np.float32, "c": np.complex64}[kind]
    x = data(kind, 4096) + np.asarray(2.0, dt)
    check(lambda m, lib: m["filt"].DcBlocker(d, long_form, dtype=dt), [x],
          chunk=chunk, atol=5e-4)


def test_goertzel():
    t = np.arange(4096)
    x = (np.sin(2 * np.pi * 1000 / 8000 * t)
         + 0.1 * data("f", 4096, seed=30)).astype(np.float32)
    got = check(lambda m, lib: m["filt"].Goertzel(8000, 64, 1000.0), [x],
                chunk=1024)[0]
    assert got.shape == (64,) and abs(abs(got[3]) - 32) < 2


@pytest.mark.parametrize("kind,ratio", [("f", 1.25), ("c", 0.8), ("f", 1.5)])
def test_fractional_interpolator(kind, ratio):
    """grtpu's block cannot run in its executor (it indexes a numpy bank
    with a traced array, see ROADMAP.md), so the port's block, through the
    executor, is held to grtpu's ``mmse_interpolate`` at the positions the
    block computes, chunk by chunk."""
    from grtpu.ops import mmse_interp as jmmse

    dt = {"f": np.float32, "c": np.complex64}[kind]
    t = np.arange(6000)
    x = np.exp(2j * np.pi * 0.02 * t)
    x = (x if kind == "c" else x.real).astype(dt)
    blk = tfilt.FractionalInterpolator(0.3, ratio, dtype=dt)
    got = run_block("t", blk, [x], 3000)[0]
    nout = 3000 // blk.decim * blk.interp
    assert got.shape == (2 * nout,)
    pos = jax.jit(lambda: 0.3 + ratio * jnp.arange(nout))()
    bank = jnp.asarray(jmmse.mmse_taps())
    xp = np.concatenate([np.zeros(8, dt), x])
    ref = np.concatenate([
        np.asarray(jmmse.mmse_interpolate(
            jnp.asarray(xp[c * 3000:(c + 1) * 3000 + 8]), pos, bank))
        for c in range(2)])
    assert rel(got, ref) < 1e-5
