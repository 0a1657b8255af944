"""grtpu_torch's polyphase filterbank (ops, blocks, clock sync) against
grtpu on the CPU.

The same numpy-seeded inputs go through ``grtpu.ops.pfb`` / ``grtpu.blocks.pfb``
and their counterparts in the port.  Tolerances, on max|diff| relative to
the reference's peak: 1e-5 for float32 matmul paths, 1e-4 for bf16x3 and
3e-2 for single-pass bf16 (both packages round the same operands to
bfloat16, so in practice they agree far closer); host-side designs are
identical.  The clock-sync loops pick a filter index per symbol, so the port
sums their dots in grtpu's order: symbols agree to 1e-5 and hard decisions
are identical.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import gengen as jgen, pfb as jblk, stream as jstream  # noqa: E402
from grtpu.ops import fir as jfir, pfb as jpfb  # noqa: E402
from grtpu.utils import firdes  # noqa: E402
from grtpu_torch.blocks import gengen as tgen, pfb as tblk, stream as tstream  # noqa: E402
from grtpu_torch.ops import pfb as tpfb  # noqa: E402

TOL = {"f32": 1e-5, "bf16x3": 1e-4, "bf16": 3e-2}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def cnoise(n, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n) + 1j * r.randn(n)).astype(np.complex64)


def tone(f, n):
    return np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)


# ------------------------------------------------------------------ designs
@pytest.mark.parametrize("nchan,tpb", [(4, 12), (16, 8), (64, 12)])
def test_design_channelizer_taps_identical(nchan, tpb):
    np.testing.assert_array_equal(jpfb.design_channelizer_taps(nchan, tpb),
                                  tpfb.design_channelizer_taps(nchan, tpb))


@pytest.mark.parametrize("rate", [1.5, 2 / 3, 160 / 147])
def test_design_arb_resampler_taps_identical(rate):
    np.testing.assert_array_equal(jpfb.design_arb_resampler_taps(rate),
                                  tpfb.design_arb_resampler_taps(rate))


def test_polyphase_taps_and_plan_identical():
    proto = np.arange(37, dtype=np.float32)
    np.testing.assert_array_equal(jpfb.polyphase_taps(proto, 8),
                                  tpfb.polyphase_taps(proto, 8))
    for a, b in zip(jpfb.arb_resampler_plan(Fraction(160, 147), 1470, 32),
                    tpfb.arb_resampler_plan(Fraction(160, 147), 1470, 32)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- channelize
@pytest.mark.parametrize("oversample", [1, 2, 4])
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
def test_channelize_matches_grtpu(precision, oversample):
    N = 16
    proto = jpfb.design_channelizer_taps(N, 8)
    kp = -(-len(proto) // N)
    x = cnoise(N * 128 + kp * N, seed=2)
    ref = jpfb.channelize(jnp.asarray(x), proto, N, oversample, precision)
    got = tpfb.channelize(torch.from_numpy(x), proto, N, oversample, precision)
    assert got.dtype == torch.complex64
    assert rel(got.numpy(), ref) < TOL[precision]


def test_channelize_odd_taps_and_tone_routing():
    """A prototype that does not fill its last branch row, and a tone that
    must land in its own channel (tests/test_pfb.py:25-44's gate)."""
    N = 8
    proto = jpfb.design_channelizer_taps(N, 12)[:-3]
    kp = -(-len(proto) // N)
    x = tone(5 / N - 0.015 / N, 4096 + kp * N)
    ref = np.asarray(jpfb.channelize(jnp.asarray(x), proto, N))
    got = tpfb.channelize(torch.from_numpy(x), proto, N).numpy()
    assert rel(got, ref) < 1e-5
    powers = (np.abs(got[kp * 2:]) ** 2).mean(axis=0)
    assert np.argmax(powers) == 5 and powers[5] / powers.sum() > 0.95


def test_channelize_rejects_bad_arguments():
    x = torch.zeros(64 + 16, dtype=torch.complex64)
    proto = tpfb.design_channelizer_taps(8, 2)
    with pytest.raises(ValueError):
        tpfb.channelize(x, proto, 8, oversample=3)
    with pytest.raises(ValueError):
        tpfb.channelize(x, proto, 8, precision="tf32")


# --------------------------------------------------------------- synthesize
def test_synthesize_matches_grtpu():
    N = 4
    proto = firdes.root_raised_cosine(1.0, N, 1.0, 0.2, 14 * N)
    proto = (proto / proto.sum()).astype(np.float32)
    kp = -(-len(proto) // N)
    ch = cnoise((512 + kp - 1) * N, seed=4).reshape(-1, N)
    ref = jpfb.synthesize(jnp.asarray(ch), proto)
    got = tpfb.synthesize(torch.from_numpy(ch), proto)
    assert got.shape == (512 * N,)
    assert rel(got.numpy(), ref) < 1e-5


def test_channelize_synthesize_roundtrip():
    """analysis -> synthesis reconstructs a band-limited input
    (tests/test_pfb.py:59-103's gate, NMSE < 0.1 at the best lag), through
    the port alone."""
    N = 4
    proto = firdes.root_raised_cosine(1.0, N, 1.0, 0.2, 14 * N)
    proto = (proto / proto.sum()).astype(np.float32)
    kp = -(-len(proto) // N)
    n, hist = 4096, kp * N
    rng = np.random.RandomState(3)
    base = (rng.randn(n // 2 + hist // 2 + 64)
            + 1j * rng.randn(n // 2 + hist // 2 + 64)).astype(np.complex64)
    up_taps = firdes.low_pass(2.0, 2.0, 0.4, 0.2)
    kpu = -(-len(up_taps) // 2)
    from grtpu_torch.ops.fir import interp_fir_filter
    xb = torch.cat([torch.zeros(kpu - 1, dtype=torch.complex64),
                    torch.from_numpy(base)])
    x = interp_fir_filter(xb, up_taps, 2)[: n + hist]
    y = tpfb.channelize(x, proto, N)
    ych = torch.cat([torch.zeros((kp - 1, N), dtype=torch.complex64), y])
    rec = tpfb.synthesize(ych, proto).numpy()
    xin = x.numpy()[hist:]
    best = 1e9
    for lag in range(0, 3 * kp * N):
        m = min(len(rec) - lag, len(xin)) - 256
        if m < 1000:
            break
        a, b = xin[256: 256 + m], rec[lag + 256: lag + 256 + m]
        g = np.vdot(b, a) / max(np.vdot(b, b).real, 1e-12)
        best = min(best, (np.abs(a - g * b) ** 2).mean()
                   / (np.abs(a) ** 2).mean())
    assert best < 0.1, best


# ------------------------------------------------------------- arb_resample
@pytest.mark.parametrize("rate", [Fraction(3, 2), Fraction(2, 3),
                                  Fraction(147, 160), Fraction(160, 147),
                                  Fraction(5, 4)], ids=str)
def test_arb_resample_matches_grtpu(rate):
    taps = jpfb.design_arb_resampler_taps(float(rate))
    kp = jpfb.polyphase_taps(taps, 32).shape[1]
    n = 6000 - 6000 % rate.denominator
    x = (tone(0.05, n + kp - 1) + 0.1 * cnoise(n + kp - 1, seed=5))
    ref = jpfb.arb_resample(jnp.asarray(x), taps, rate)
    got = tpfb.arb_resample(torch.from_numpy(x), taps, rate)
    assert got.shape == (int(n * rate),)
    assert rel(got.numpy(), ref) < 1e-5
    # tone fidelity (tests/test_pfb.py:161-179)
    seg = tpfb.arb_resample(torch.from_numpy(tone(0.05, n + kp - 1)), taps,
                            rate).numpy()[200:-200]
    dphi = np.angle(seg[1:] * np.conj(seg[:-1])).mean() / (2 * np.pi)
    assert abs(dphi - 0.05 / float(rate)) < 1e-4
    assert abs(np.abs(seg).mean() - 1.0) < 0.05


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_arb_resample_precision_argument(precision, monkeypatch):
    """grtpu reads the matmul mode from its FIR module's global; the port
    takes it per call."""
    rate = Fraction(3, 2)
    taps = jpfb.design_arb_resampler_taps(float(rate))
    kp = jpfb.polyphase_taps(taps, 32).shape[1]
    x = cnoise(3000 + kp - 1, seed=6)
    got = tpfb.arb_resample(torch.from_numpy(x), taps, rate,
                            precision=precision).numpy()
    exact = tpfb.arb_resample(torch.from_numpy(x), taps, rate).numpy()
    assert rel(got, exact) < TOL[precision]
    if precision == "bf16x3":  # grtpu's global knows f32 and bf16x3 only
        monkeypatch.setattr(jfir, "_PRECISION", "bf16x3")
        ref = jpfb.arb_resample(jnp.asarray(x), taps, rate)
        assert rel(got, ref) < 1e-5


def test_arb_resample_batched_rows_and_real_input():
    rate = Fraction(160, 147)
    taps = jpfb.design_arb_resampler_taps(float(rate))
    kp = jpfb.polyphase_taps(taps, 32).shape[1]
    x = cnoise(3 * (1470 + kp - 1), seed=7).reshape(3, -1)
    got = tpfb.arb_resample(torch.from_numpy(x), taps, rate).numpy()
    for r in range(3):
        ref = jpfb.arb_resample(jnp.asarray(x[r]), taps, rate)
        assert rel(got[r], ref) < 1e-5
    xr = np.ascontiguousarray(x[0].real)
    ref = jpfb.arb_resample(jnp.asarray(xr), taps, rate)
    got = tpfb.arb_resample(torch.from_numpy(xr), taps, rate)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), ref) < 1e-5


# ------------------------------------------------------------------- blocks
def _graph(pkg, lib, chain, in_port, out_port):
    g = pkg.Graph()
    pin = g.add_input(in_port)
    pout = g.add_output(out_port)
    g.connect(pin, *chain, pout)
    return g


def _run(pkg, g, x, chunk):
    if pkg is grtpu:
        return np.asarray(pkg.StreamExecutor(g, chunk_size=chunk).run(
            jnp.asarray(x)))
    return pkg.StreamExecutor(g, chunk_size=chunk, device="cpu").run(x).numpy()


def _both(make, x, chunk, vlen_in=1, vlen_out=1):
    outs = []
    for pkg, lib, mod in ((grtpu, jnp, "j"), (grtpu_torch, torch, "t")):
        g = _graph(pkg, lib, make(mod), pkg.Port(lib.complex64, vlen_in),
                   pkg.Port(lib.complex64, vlen_out))
        outs.append(_run(pkg, g, x, chunk))
    return outs


BLOCKS = {
    "channelizer": (lambda m: [(jblk if m == "j" else tblk).PfbChannelizer(8)],
                    1, 8, Fraction(1, 8)),
    "channelizer_os2_bf16x3": (
        lambda m: [(jblk if m == "j" else tblk).PfbChannelizer(
            8, oversample=2, precision="bf16x3")], 1, 8, Fraction(1, 4)),
    "decimator": (lambda m: [(jblk if m == "j" else tblk).PfbDecimator(
        8, channel=3)], 1, 1, Fraction(1, 8)),
    "interpolator": (lambda m: [(jblk if m == "j" else tblk).PfbInterpolator(
        4)], 1, 1, Fraction(4)),
    "arb_resampler": (lambda m: [(jblk if m == "j" else tblk).PfbArbResampler(
        160 / 147)], 1, 1, Fraction(160, 147)),
    "arb_resampler_down": (
        lambda m: [(jblk if m == "j" else tblk).PfbArbResampler(0.75)],
        1, 1, Fraction(3, 4)),
    "channelizer_synthesizer": (
        lambda m: [(jblk if m == "j" else tblk).PfbChannelizer(4),
                   (jblk if m == "j" else tblk).PfbSynthesizer(4)],
        1, 1, Fraction(1)),
    "stream_to_vector_synthesizer": (
        lambda m: [(jstream if m == "j" else tstream).StreamToVector(
            jnp.complex64 if m == "j" else torch.complex64, 4),
            (jblk if m == "j" else tblk).PfbSynthesizer(4)],
        1, 1, Fraction(1)),
}


@pytest.mark.parametrize("chunk", [1176, 2352])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_pfb_block_graph_matches_grtpu(name, chunk):
    """Each filterbank block as a graph through both executors, at two chunk
    sizes (the history halo of a trailing item axis included); the port's
    chunked output also equals its one-call output."""
    make, vin, vout, rate = BLOCKS[name]
    n = 4 * 2352
    x = tone(1 / 8 + 0.004, n) + 0.05 * cnoise(n, seed=8)
    ref, got = _both(make, x, chunk, vin, vout)
    assert got.shape[0] == int(n * rate)
    assert rel(got, ref) < (1e-4 if "bf16x3" in name else 1e-5)
    whole = _run(grtpu_torch, _graph(
        grtpu_torch, torch, make("t"), grtpu_torch.Port(torch.complex64, vin),
        grtpu_torch.Port(torch.complex64, vout)), x, n)
    assert rel(got, whole) < 1e-5


def test_channelizer_block_sink_and_vector_port():
    """grtpu's own block test (tests/test_pfb.py:210-229): a VectorSink of
    vector items behind the channelizer."""
    N = 4
    g = grtpu_torch.Graph()
    pin = g.add_input(grtpu_torch.Port(torch.complex64))
    sink = tgen.VectorSink(torch.complex64, vlen=N)
    blk = tblk.PfbChannelizer(N)
    assert blk.out_ports[0].vlen == N and blk.decim == N
    g.connect(pin, blk, sink)
    grtpu_torch.StreamExecutor(g, chunk_size=1024, device="cpu").run(
        tone(1 / N + 0.005, 4096))
    y = sink.data()
    assert y.shape == (1024, N)
    assert np.argmax((np.abs(y[200:]) ** 2).mean(axis=0)) == 1


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_channelizer_checkpoint_moves_between_packages(tmp_path, writer,
                                                       reader):
    """The channelizer's halo tail and the synthesizer's (a tail with a
    trailing item axis) resume in the other package."""
    def ex(kind):
        pkg, lib, mod = ((grtpu, jnp, jblk) if kind == "jax"
                         else (grtpu_torch, torch, tblk))
        g = _graph(pkg, lib, [mod.PfbChannelizer(4), mod.PfbSynthesizer(4)],
                   pkg.Port(lib.complex64), pkg.Port(lib.complex64))
        kw = {} if kind == "jax" else {"device": "cpu"}
        return pkg.StreamExecutor(g, chunk_size=512, **kw)

    def run(e, kind, x):
        y = e.run(jnp.asarray(x) if kind == "jax" else x)
        return np.asarray(y) if kind == "jax" else y.numpy()

    x = cnoise(2048, seed=9)
    full = run(ex(writer), writer, x)
    first = ex(writer)
    run(first, writer, x[:1024])
    path = str(tmp_path / "pfb.npz")
    first.save_checkpoint(path)
    second = ex(reader)
    second.load_checkpoint(path)
    assert rel(run(second, reader, x[1024:]), full[1024:]) < 1e-5


# --------------------------------------------------------------- clock sync
SPS, NFILTS = 4, 32


def _mf_taps(sps=SPS):
    return firdes.root_raised_cosine(NFILTS, NFILTS * sps, 1.0, 0.35,
                                     int(11 * sps) * NFILTS)


def _qpsk_wave(nsym, seed, sps=SPS, stretch=1.0001):
    rng = np.random.default_rng(seed)
    syms = ((rng.integers(0, 2, nsym) * 2 - 1)
            + 1j * (rng.integers(0, 2, nsym) * 2 - 1)) / np.sqrt(2)
    up = np.zeros(nsym * sps, np.complex128)
    up[::sps] = syms
    h = firdes.root_raised_cosine(1.0, sps, 1.0, 0.35, 11 * sps)
    x = np.convolve(up, h, "same")
    t = np.arange(0, len(x) - 2, stretch)
    fr = t % 1
    x = (1 - fr) * x[t.astype(int)] + fr * x[t.astype(int) + 1]
    noise = 0.02 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x)))
    return (x + noise).astype(np.complex64)


def _decisions(y):
    y = np.asarray(y)
    return (y.real > 0).astype(np.int8) * 2 + (y.imag > 0)


def _state_np(st):
    return [float(np.asarray(s)) for s in st]


@pytest.mark.parametrize("diag", [False, True], ids=["plain", "diag"])
def test_pfb_clock_sync_matches_grtpu(diag):
    x = _qpsk_wave(400, seed=0)
    taps = _mf_taps()
    jy, jn, jst = jblk.pfb_clock_sync(
        jnp.asarray(x), jblk.pfb_clock_sync_init(NFILTS), float(SPS), taps,
        NFILTS, 0.06, with_diag=diag)
    ty, tn, tst = tblk.pfb_clock_sync(
        torch.from_numpy(x), tblk.pfb_clock_sync_init(NFILTS, device="cpu"),
        float(SPS), taps, NFILTS, 0.06, with_diag=diag)
    nv = int(jn)
    assert int(tn) == nv and nv > 350
    if diag:
        for a, b in zip(jy[1:], ty[1:]):
            np.testing.assert_allclose(b.numpy()[:nv], np.asarray(a)[:nv],
                                       atol=1e-5)
        jy, ty = jy[0], ty[0]
    assert ty.shape == jy.shape
    assert np.abs(ty.numpy()[:nv] - np.asarray(jy)[:nv]).max() < 1e-5
    np.testing.assert_array_equal(_decisions(ty.numpy()[:nv]),
                                  _decisions(jy[:nv]))
    np.testing.assert_allclose(_state_np(tst), _state_np(jst), atol=1e-4)


def test_pfb_clock_sync_explicit_gains_and_real_stream():
    x = np.ascontiguousarray(_qpsk_wave(200, seed=1).real)
    taps = _mf_taps()
    jy, jn, _ = jblk.pfb_clock_sync(
        jnp.asarray(x), jblk.pfb_clock_sync_init(NFILTS), float(SPS), taps,
        NFILTS, 0.0, gains=(0.05, 0.001))
    ty, tn, _ = tblk.pfb_clock_sync(
        torch.from_numpy(x), tblk.pfb_clock_sync_init(NFILTS, device="cpu"),
        float(SPS), taps, NFILTS, 0.0, gains=(0.05, 0.001))
    nv = int(jn)
    assert int(tn) == nv and ty.dtype == torch.float32
    assert np.abs(ty.numpy()[:nv] - np.asarray(jy)[:nv]).max() < 1e-5


@pytest.mark.parametrize("sps", [4, 4.25], ids=["sps4", "sps4.25"])
def test_pfb_clock_sync_windowed_matches_grtpu(sps):
    W = 8  # a narrow window and a short prototype keep jax's compile short
    gen = 5 if sps != int(sps) else int(sps)
    x = _qpsk_wave(200, seed=2, sps=gen, stretch=gen / sps * 1.0001)
    taps = firdes.root_raised_cosine(NFILTS, NFILTS * sps, 1.0, 0.35,
                                     int(5 * sps) * NFILTS)
    xw = np.concatenate([np.zeros(W, np.complex64), x,
                         np.zeros(2 * W, np.complex64)])
    jy, jst = jblk.pfb_clock_sync_windowed(
        jnp.asarray(xw), jblk.pfb_clock_sync_windowed_init(NFILTS), sps, taps,
        NFILTS, 0.06, W=W)
    ty, tst = tblk.pfb_clock_sync_windowed(
        torch.from_numpy(xw),
        tblk.pfb_clock_sync_windowed_init(NFILTS, device="cpu"), sps, taps,
        NFILTS, 0.06, W=W)
    assert ty.shape == jy.shape and ty.shape[0] > 150
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-5
    np.testing.assert_array_equal(_decisions(ty.numpy()), _decisions(jy))
    np.testing.assert_allclose(_state_np(tst), _state_np(jst), atol=1e-4)
    # the windowed form tracks the port's own exact loop (grtpu's
    # bit-exactness test, tests/test_pfb.py:288-323)
    ey, en, _ = tblk.pfb_clock_sync(
        torch.from_numpy(x), tblk.pfb_clock_sync_init(NFILTS, device="cpu"),
        float(sps), taps, NFILTS, 0.06)
    n = min(int(en), ty.shape[0])
    assert n > 150
    assert np.abs(ey.numpy()[:n] - ty.numpy()[:n]).max() < 1e-5


def _chunked_input(nsym, W, chunk, kp, exact_multiple):
    """A stream whose symbol count T is (or is not) a multiple of chunk."""
    x = _qpsk_wave(nsym, seed=3)
    L = SPS + 2 * W + kp
    T = (len(x) + W - L) // SPS + 1
    want = (T // chunk) * chunk if exact_multiple else (T // chunk) * chunk + 5
    n = (want - 1) * SPS + L
    return np.concatenate([np.zeros(W, np.complex64), x])[:n]


def test_pfb_clock_sync_chunked_matches_grtpu():
    W, chunk = 32, 64
    taps = _mf_taps()
    kp = -(-len(taps) // NFILTS)
    xw = _chunked_input(400, W, chunk, kp, exact_multiple=False)
    jy, jst = jblk.pfb_clock_sync_chunked(
        jnp.asarray(xw), jblk.pfb_clock_sync_windowed_init(NFILTS), SPS, taps,
        NFILTS, 0.06, W=W, chunk=chunk)
    ty, tst = tblk.pfb_clock_sync_chunked(
        torch.from_numpy(xw),
        tblk.pfb_clock_sync_windowed_init(NFILTS, device="cpu"), SPS, taps,
        NFILTS, 0.06, W=W, chunk=chunk)
    assert ty.shape == jy.shape and ty.shape[0] % chunk == 0
    assert ty.shape[0] >= 5 * chunk
    # both round samples and banks to bfloat16 and sum in float32
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-4
    np.testing.assert_array_equal(_decisions(ty.numpy()), _decisions(jy))
    np.testing.assert_allclose(_state_np(tst), _state_np(jst), atol=1e-3)


def test_pfb_clock_sync_chunked_exact_multiple_against_windowed():
    """At T % chunk == 0 grtpu clamps its last chunk's start (a known fault
    of the reference), so the port is held to its own windowed form there:
    the same decisions once the loop has locked."""
    W, chunk = 32, 64
    taps = _mf_taps()
    kp = -(-len(taps) // NFILTS)
    xw = torch.from_numpy(_chunked_input(400, W, chunk, kp,
                                         exact_multiple=True))
    init = tblk.pfb_clock_sync_windowed_init(NFILTS, device="cpu")
    cy, _ = tblk.pfb_clock_sync_chunked(xw, init, SPS, taps, NFILTS, 0.06,
                                        W=W, chunk=chunk)
    wy, _ = tblk.pfb_clock_sync_windowed(xw, init, SPS, taps, NFILTS, 0.06,
                                         W=W)
    assert cy.shape[0] == wy.shape[0] and cy.shape[0] % chunk == 0
    agree = (_decisions(cy.numpy()[128:]) == _decisions(wy.numpy()[128:]))
    assert agree.mean() > 0.99


@pytest.mark.parametrize("chunk", [512, 1024])
def test_pfb_clock_sync_block_matches_grtpu(chunk):
    """PfbClockSync as a variable-rate block through both executors: the
    same symbols out of the FIFO, and the chunked run equals the run that
    takes the stream as one chunk."""
    x = _qpsk_wave(400, seed=4)
    x = x[: len(x) // 512 * 512]
    taps = _mf_taps()
    outs = []
    for pkg, lib, mod in ((grtpu, jnp, jblk), (grtpu_torch, torch, tblk)):
        g = _graph(pkg, lib, [mod.PfbClockSync(float(SPS), 0.06, taps,
                                               NFILTS)],
                   pkg.Port(lib.complex64), pkg.Port(lib.complex64))
        outs.append(_run(pkg, g, x, chunk))
    ref, got = outs
    assert got.shape == ref.shape and got.shape[0] > 300
    assert np.abs(got - ref).max() < 1e-5
    np.testing.assert_array_equal(_decisions(got), _decisions(ref))
    g = _graph(grtpu_torch, torch,
               [tblk.PfbClockSync(float(SPS), 0.06, taps, NFILTS)],
               grtpu_torch.Port(torch.complex64),
               grtpu_torch.Port(torch.complex64))
    whole = _run(grtpu_torch, g, x, len(x))
    n = min(got.shape[0], whole.shape[0])
    assert n > 300
    assert np.abs(whole[:n] - got[:n]).max() < 1e-5


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_pfb_clock_sync_checkpoint_moves_between_packages(tmp_path, writer,
                                                          reader):
    """The (k, rate, base) 3-tuple, the halo tail and the FIFO resume in the
    other package."""
    taps = _mf_taps()

    def ex(kind):
        pkg, lib, mod = ((grtpu, jnp, jblk) if kind == "jax"
                         else (grtpu_torch, torch, tblk))
        g = _graph(pkg, lib, [mod.PfbClockSync(float(SPS), 0.06, taps,
                                               NFILTS)],
                   pkg.Port(lib.complex64), pkg.Port(lib.complex64))
        kw = {} if kind == "jax" else {"device": "cpu"}
        return pkg.StreamExecutor(g, chunk_size=512, **kw)

    def run(e, kind, x):
        y = e.run(jnp.asarray(x) if kind == "jax" else x)
        return np.asarray(y) if kind == "jax" else y.numpy()

    x = _qpsk_wave(300, seed=5)[:1024]
    full = run(ex(writer), writer, x)
    first = ex(writer)
    head = run(first, writer, x[:512])
    path = str(tmp_path / "sync.npz")
    first.save_checkpoint(path)
    second = ex(reader)
    second.load_checkpoint(path)
    tail = run(second, reader, x[512:])
    got = np.concatenate([head, tail])
    assert got.shape == full.shape
    assert np.abs(got - full).max() < 1e-5
