"""grtpu_torch.blocks.{misc,fftblk,oscope,selftest} held against grtpu.

Each block runs through both packages' executors on the same numpy input
(local seeds); the port's runs are eager and under ``run(device_loop=True)``
(on the CPU the static-buffer step without a graph), at a chunk that does
not divide the stream.  Tolerances are grtpu's own tests'
(tests/test_pager_misc.py, test_pmt_tags.py, test_runtime.py,
test_io_aux.py, test_apps.py): exact for integer and decision outputs
(``DpllBB``, ``Threshold``, selftest), 1e-5 for ``IqComp``.  BurstTagger's
tags are compared as (offset, key, value) tuples, exactly.  CtcssSquelch is
held to grtpu at chunks that are multiples of its block and to a numpy
model of the block gate it carries at ragged chunks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
from grtpu.blocks import fftblk as jfft  # noqa: E402
from grtpu.blocks import gengen as jgen  # noqa: E402
from grtpu.blocks import misc as jmisc  # noqa: E402
from grtpu.blocks import oscope as josc  # noqa: E402
from grtpu.blocks import selftest as jself  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu_torch.blocks import fftblk as tfft  # noqa: E402
from grtpu_torch.blocks import gengen as tgen  # noqa: E402
from grtpu_torch.blocks import misc as tmisc  # noqa: E402
from grtpu_torch.blocks import oscope as tosc  # noqa: E402
from grtpu_torch.blocks import selftest as tself  # noqa: E402

MODES = ["eager", "device_loop"]
PKG = {"j": grtpu, "t": grtpu_torch}


def host(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def run_block(kind, blk, xs, chunk, mode="eager"):
    """input pads -> blk -> output pads; returns the outputs as numpy."""
    pkg = PKG[kind]
    g = pkg.Graph()
    for i, p in enumerate(blk.in_ports):
        g.connect(g.add_input(pkg.Port(p.dtype, p.vlen)), (blk, i))
    for i, p in enumerate(blk.out_ports):
        g.connect((blk, i), g.add_output(pkg.Port(p.dtype, p.vlen)))
    if kind == "j":
        ex = pkg.StreamExecutor(g, chunk_size=chunk, donate=False)
        res = ex.run(*[jnp.asarray(x) for x in xs])
    else:
        ex = pkg.StreamExecutor(g, chunk_size=chunk, device="cpu")
        res = ex.run(*[torch.from_numpy(np.array(x)) for x in xs],
                     device_loop=mode == "device_loop")
    if not blk.out_ports:
        return None
    if len(blk.out_ports) == 1:
        return host(res)
    return [host(r) for r in res]


def both(make, xs, chunk, mode):
    """The same block built in each package: (grtpu's output, the port's)."""
    return (run_block("j", make(jmisc, jnp), xs, chunk),
            run_block("t", make(tmisc, torch), xs, chunk, mode))


RNG_CASES = {
    "nlog10": (lambda m, L: m.NLog10(20.0, 3.0),
               lambda r: [np.abs(r.randn(300)).astype(np.float32) + 1e-3]),
    "sin": (lambda m, L: m.Transcendental("sin"),
            lambda r: [r.randn(300).astype(np.float32)]),
    "tanh": (lambda m, L: m.Transcendental("tanh"),
             lambda r: [r.randn(300).astype(np.float32)]),
    "sqrt": (lambda m, L: m.Transcendental("sqrt"),
             lambda r: [np.abs(r.randn(300)).astype(np.float32)]),
    "standard_squelch": (lambda m, L: m.StandardSquelch(8000.0, 0.5),
                         lambda r: [r.randn(300).astype(np.float32)]),
    "cpfsk": (lambda m, L: m.Cpfsk(0.5, 1.0, 4),
              lambda r: [r.randint(0, 2, 300).astype(np.uint8)]),
    "annotator": (lambda m, L: m.Annotator(),
                  lambda r: [r.randn(300).astype(np.float32)]),
    "error_rate_ber": (lambda m, L: m.ErrorRate("BER", 50, 2),
                       lambda r: [r.randint(0, 4, 300).astype(np.uint8),
                                  r.randint(0, 4, 300).astype(np.uint8)]),
    "error_rate_ser": (lambda m, L: m.ErrorRate("SER", 64, 2),
                       lambda r: [r.randint(0, 2, 300).astype(np.uint8),
                                  r.randint(0, 2, 300).astype(np.uint8)]),
    "selector": (lambda m, L: m.Selector(L.float32, 2, 2, 1, 0),
                 lambda r: [r.randn(300).astype(np.float32),
                            r.randn(300).astype(np.float32)]),
    "valve_open": (lambda m, L: m.Valve(L.float32, open=True),
                   lambda r: [r.randn(300).astype(np.float32)]),
    "valve_closed": (lambda m, L: m.Valve(L.float32, open=False),
                     lambda r: [r.randn(300).astype(np.float32)]),
    "threshold": (lambda m, L: m.Threshold(-0.3, 0.3),
                  lambda r: [r.randn(300).astype(np.float32)]),
    "wavelet_fwd": (lambda m, L: m.WaveletFF(16, 4, True),
                    lambda r: [r.randn(20, 16).astype(np.float32)]),
    "wavelet_inv": (lambda m, L: m.WaveletFF(16, 6, False),
                    lambda r: [r.randn(20, 16).astype(np.float32)]),
}
EXACT = {"annotator", "selector", "valve_open", "valve_closed", "threshold",
         "error_rate_ber", "error_rate_ser"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(RNG_CASES))
def test_block_equals_grtpu(case, mode):
    make, data = RNG_CASES[case]
    xs = data(np.random.RandomState(11))
    chunk = 7 if case.startswith("wavelet") else 128
    want, got = both(make, xs, chunk, mode)
    if case in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_daubechies_and_dwt_matrix_identical_to_grtpu():
    for order in (2, 4, 6, 10, 20):
        np.testing.assert_array_equal(tmisc.daubechies_taps(order),
                                      jmisc.daubechies_taps(order))
    for fwd in (True, False):
        np.testing.assert_array_equal(tmisc._dwt_matrix(32, 8, fwd),
                                      jmisc._dwt_matrix(32, 8, fwd))


def test_threshold_hysteresis_and_carry():
    blk = tmisc.Threshold(lo=-0.5, hi=0.5)
    x = np.array([0.0, 0.6, 0.2, -0.2, -0.6, 0.0, 0.7, -0.7, 0.3], np.float32)
    st, y = blk.apply(blk.init_state(), torch.from_numpy(x))
    assert y.tolist() == [0, 1, 1, 1, 0, 0, 1, 0, 0]
    _, y2 = blk.apply(st, torch.tensor([0.1]))
    assert float(y2[0]) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_dpll_bb_equals_grtpu_exactly(mode):
    r = np.random.RandomState(5)
    # a pulse train near period 7 with jitter and drops
    x = np.zeros(700, np.uint8)
    pos = np.cumsum(7 + r.randint(-1, 2, 100))
    x[pos[pos < 700]] = 1
    x[r.randint(0, 700, 20)] = 0
    want, got = both(lambda m, L: m.DpllBB(7.3, 0.2), [x], 96, mode)
    assert got.dtype == np.uint8 and got.sum() > 50
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_iqcomp_against_grtpu_and_the_reference_recurrence(mode):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300)
         ).astype(np.complex64)
    mu = 0.01
    want, got = both(lambda m, L: m.IqComp(mu), [x], 128, mode)
    np.testing.assert_allclose(got, want, atol=1e-5)
    wi = wq = 0.0
    ref = np.zeros(300, np.complex64)
    for i, s in enumerate(x):   # gr_iqcomp_cc.cc:52-58
        i_out = s.real - s.imag * wq
        q_out = s.imag - s.real * wi
        wi += mu * q_out * s.real
        wq += mu * i_out * s.imag
        ref[i] = i_out + 1j * q_out
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_iqcomp_decorrelates_iq():
    rng = np.random.default_rng(2)
    clean = np.exp(1j * 2 * np.pi * rng.random(4096)).astype(np.complex64)
    bad = (clean.real + 0.2 * clean.imag
           + 1j * (clean.imag + 0.15 * clean.real)).astype(np.complex64)
    blk = tmisc.IqComp(0.01)
    _, y = blk.apply(blk.init_state(), torch.from_numpy(bad))
    tail, bt = y.numpy()[-1024:], bad[-1024:]
    corr_before = abs(np.mean(bt.real * bt.imag))
    assert abs(np.mean(tail.real * bt.imag)) < corr_before * 0.1
    assert abs(np.mean(tail.imag * bt.real)) < corr_before * 0.1


def test_grtest_fixture():
    blk = tmisc.GrTest(produce_extra=3, inject_nan=True)
    x = torch.arange(5, dtype=torch.float32)
    _, y = blk.apply((), x)
    assert y.shape == (8,) and torch.isnan(y[0]) and float(y[1]) == 1.0
    assert float(x[0]) == 0.0
    jblk = jmisc.GrTest(produce_extra=3, inject_nan=True)
    _, jy = jblk.apply((), jnp.arange(5, dtype=jnp.float32))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_probes_and_host_sinks_equal_grtpu():
    r = np.random.RandomState(3)
    bits = r.randint(0, 2, 400).astype(np.uint8)
    iq = ((1 + 0.1 * r.randn(400)) * np.exp(1j * r.rand(400))
          ).astype(np.complex64)
    vecs = r.randn(12, 8).astype(np.float32)
    f = r.randn(400).astype(np.float32)
    for kind, m in (("j", jmisc), ("t", tmisc)):
        pd, snr, bs, hs = (m.ProbeDensity(0.05), m.ProbeMpskSnr(),
                           m.BinStatistics(8), m.HistoSink(20))
        run_block(kind, pd, [bits], 96)
        run_block(kind, snr, [iq], 96)
        run_block(kind, bs, [vecs], 5)
        run_block(kind, hs, [f], 96)
        if kind == "j":
            want = (pd.density(), snr.snr_db(), bs.max_hold(), bs.mean(),
                    hs.histogram())
    got = (pd.density(), snr.snr_db(), bs.max_hold(), bs.mean(),
           hs.histogram())
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    np.testing.assert_array_equal(got[4][0], want[4][0])
    np.testing.assert_allclose(got[4][1], want[4][1], rtol=1e-6)


# ------------------------------------------------------------ CtcssSquelch
FS, NB = 8000.0, 1024


def _ctcss_signal(n=4096, seed=9):
    t = np.arange(n) / FS
    voice = np.sin(2 * np.pi * 440 * t)
    tone = 0.15 * np.sin(2 * np.pi * 100.0 * t)
    on = (np.arange(n) // 1500) % 2 == 0        # tone keyed on and off
    noise = 0.01 * np.random.RandomState(seed).randn(n)
    return (voice + np.where(on, tone, 0) + noise).astype(np.float32)


def _ctcss_golden(x, chunks, level=0.005, block=NB, freq=100.0):
    """gr_ctcss_squelch's block gate with the partial block carried:
    blocks counted from the start of the stream; a sample takes its own
    block's decision when the block completes inside the sample's chunk,
    else the decision of the last block completed by the end of that chunk
    (closed before the first)."""
    n = len(x)
    # the executor zero-pads the last chunk
    x = np.concatenate([x, np.zeros(sum(chunks) - n, np.float32)])
    nblk = len(x) // block
    k = freq * block / FS
    w = np.exp(-2j * np.pi * k / block * np.arange(block))
    xb = x[:nblk * block].astype(np.float64).reshape(nblk, block)
    p_tone = np.abs((xb * w).sum(1)) ** 2 / block
    open_ = p_tone / ((xb ** 2).sum(1) + 1e-12) > level
    gate, start, last = np.zeros(len(x)), 0, False
    for c in chunks:
        end = start + c
        done = end // block                  # blocks complete by chunk end
        if done:
            last = open_[done - 1]
        for i in range(start, end):
            b = i // block
            gate[i] = open_[b] if b < done else last
        start = end
    return (x * gate)[:n].astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_ctcss_squelch_equals_grtpu_at_multiples_of_the_block(mode):
    x = _ctcss_signal()
    want, got = both(lambda m, L: m.CtcssSquelch(FS, 100.0, 0.005, NB),
                     [x], 2048, mode)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got == 0).sum() == (want == 0).sum()
    assert np.abs(got[:1024]).mean() > 0.3         # tone: gate open
    assert np.abs(got[2048:3072]).mean() < 0.05    # no tone: gate closed


@pytest.mark.parametrize("chunk", [1000, 700, 1024])
@pytest.mark.parametrize("mode", MODES)
def test_ctcss_squelch_carries_its_block_at_ragged_chunks(chunk, mode):
    x = _ctcss_signal(5000)
    got = run_block("t", tmisc.CtcssSquelch(FS, 100.0, 0.005, NB), [x],
                    chunk, mode)
    chunks = [chunk] * (-(-len(x) // chunk))
    np.testing.assert_allclose(got, _ctcss_golden(x, chunks), atol=1e-6)
    # a chunk below the block no longer mutes everything
    assert np.abs(got).mean() > 0.1


# ------------------------------------------------------------ BurstTagger
def burst_graph(kind, chunk, with_clock=False):
    pkg, L = PKG[kind], (jnp if kind == "j" else torch)
    m = jmisc if kind == "j" else tmisc
    gen = jgen if kind == "j" else tgen
    g = pkg.Graph()
    psig = g.add_input(pkg.Port(L.complex64))
    pmag = g.add_input(pkg.Port(L.float32))
    bt = m.BurstTagger(threshold=0.5)
    s = gen.VectorSink(dtype=L.complex64, name="tagsink")
    g.connect(psig, (bt, 0))
    g.connect(pmag, (bt, 1))
    if with_clock:
        from grtpu.digital import blocks as jdb
        from grtpu_torch.digital import blocks as tdb
        db = jdb if kind == "j" else tdb
        g.connect(bt, db.ClockRecoveryMMCC(4, 0.25e-4, 0.5, 0.01), s)
    else:
        g.connect(bt, s)
    kw = {"donate": False} if kind == "j" else {"device": "cpu"}
    return pkg.StreamExecutor(g, chunk_size=chunk, **kw), s


def burst_tags(kind, sig, mag, chunk, mode="eager", with_clock=False):
    ex, s = burst_graph(kind, chunk, with_clock)
    if kind == "j":
        ex.run(jnp.asarray(sig), jnp.asarray(mag),
               device_loop=mode == "device_loop")
    else:
        ex.run(torch.from_numpy(sig), torch.from_numpy(mag),
               device_loop=mode == "device_loop")
    return sorted((t.offset, t.key, t.value)
                  for t in ex.sink_tags.get(s.name, [])), s


@pytest.mark.parametrize("mode", MODES)
def test_burst_tagger_emits_transitions(mode):
    """tests/test_pmt_tags.py:218-247."""
    n = 64
    sig = np.arange(n).astype(np.complex64)
    mag = np.zeros(n, np.float32)
    mag[10:20] = 1.0
    mag[40:55] = 1.0
    tags, s = burst_tags("t", sig, mag, 16, mode)
    assert [(o, v) for o, k, v in tags if k == "burst"] == \
        [(10, True), (20, False), (40, True), (55, False)]
    np.testing.assert_array_equal(s.data(), sig)
    assert tags == burst_tags("j", sig, mag, 16)[0]


@pytest.mark.parametrize("mode", MODES)
def test_burst_tagger_cuts_bursts(mode):
    """tests/test_pmt_tags.py:249-274's bursts, read off the tags (the
    tagged file sink waits for the I/O slice)."""
    n = 64
    sig = (np.arange(n) + 1j * np.arange(n)).astype(np.complex64)
    mag = np.zeros(n, np.float32)
    mag[8:24] = 1.0
    mag[32:48] = 1.0
    tags, s = burst_tags("t", sig, mag, 16, mode)
    starts = [o for o, k, v in tags if v is True]
    ends = [o for o, k, v in tags if v is False]
    assert list(zip(starts, ends)) == [(8, 24), (32, 48)]
    np.testing.assert_array_equal(s.data()[8:24], sig[8:24])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burst_tagger_device_loop_matches_step_and_grtpu(seed):
    """tests/test_pmt_tags.py:305-345: random bursts crossing chunks."""
    n = 128
    mag = np.zeros(n, np.float32)
    r = np.random.RandomState(seed)
    for _ in range(3):
        a = int(r.randint(0, n - 8))
        mag[a:a + int(r.randint(3, 20))] = 1.0
    sig = (np.arange(n) + 1j).astype(np.complex64)
    eager = burst_tags("t", sig, mag, 32, "eager")[0]
    loop = burst_tags("t", sig, mag, 32, "device_loop")[0]
    assert eager == loop == burst_tags("j", sig, mag, 32)[0]
    assert len(eager) > 0


def test_burst_tagger_through_a_variable_rate_block():
    """tests/test_pmt_tags.py:470-510: tags through ClockRecoveryMMCC land
    in symbol coordinates, equal in both modes."""
    sps, n = 4, 1024
    r = np.random.default_rng(2)
    syms = r.choice([-1.0, 1.0], size=n // sps + 8)
    sig = np.repeat(syms, sps)[:n].astype(np.complex64)
    mag = np.zeros(n, np.float32)
    mag[100:400] = 1.0
    t1 = burst_tags("t", sig, mag, 256, "eager", with_clock=True)[0]
    t2 = burst_tags("t", sig, mag, 256, "device_loop", with_clock=True)[0]
    assert t1 == t2 and len(t1) == 2
    offs = [o for o, _k, _v in t1]
    assert 100 // sps - 2 <= offs[0] <= 100 // sps + 2


# ------------------------------------------------------------ fftblk
@pytest.mark.parametrize("mode", MODES)
def test_fft_blocks_equal_grtpu(mode):
    r = np.random.RandomState(4)
    n_fft = 16
    x = (r.randn(10, n_fft) + 1j * r.randn(10, n_fft)).astype(np.complex64)
    xf = r.randn(10, n_fft).astype(np.float32)
    win = np.hanning(n_fft)
    for make, data in (
            (lambda m: m.FftVcc(n_fft, True, win, shift=True), x),
            (lambda m: m.FftVcc(n_fft, False, None, shift=True), x),
            (lambda m: m.FftVcc(n_fft, False, win), x),
            (lambda m: m.FftVfc(n_fft, True, win, shift=True), xf)):
        want = run_block("j", make(jfft), [data], 3)
        got = run_block("t", make(tfft), [data], 3, mode)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    s = r.randn(96).astype(np.complex64)
    want = run_block("j", jfft.StreamToVectorDecimator(8, 3, jnp.complex64),
                     [s], 48)
    got = run_block("t", tfft.StreamToVectorDecimator(8, 3, torch.complex64),
                    [s], 48, mode)
    np.testing.assert_array_equal(got, want)


def _logpwr(kind, alpha, x, mode="eager"):
    pkg, L = PKG[kind], (jnp if kind == "j" else torch)
    fft, gen = (jfft, jgen) if kind == "j" else (tfft, tgen)
    fs, n_fft = 32000.0, 128
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(L.complex64))
    lp = fft.LogPwrFft(fs, n_fft, frame_rate=fs / n_fft, avg_alpha=alpha)
    sink = gen.VectorSink(L.float32, vlen=n_fft)
    g.connect(pin, lp, sink)
    if kind == "j":
        pkg.StreamExecutor(g, chunk_size=1024, donate=False).run(
            jnp.asarray(x))
    else:
        pkg.StreamExecutor(g, chunk_size=1024, device="cpu").run(
            torch.from_numpy(x), device_loop=mode == "device_loop")
    return sink.data()


@pytest.mark.parametrize("mode", MODES)
def test_logpwrfft_tone_bin_and_grtpu(mode):
    fs, n_fft, f = 32000.0, 128, 4000.0
    x = np.exp(2j * np.pi * f / fs * np.arange(4096)).astype(np.complex64)
    spec = _logpwr("t", 1.0, x, mode)
    assert np.argmax(spec[2]) == n_fft // 2 + int(f / fs * n_fft)
    # in power, against the peak: the empty bins are float rounding
    want = _logpwr("j", 1.0, x)
    peak = (10 ** (want / 10)).max()
    np.testing.assert_allclose(10 ** (spec / 10) / peak,
                               10 ** (want / 10) / peak, atol=1e-6)


def test_logpwrfft_ignores_avg_alpha_as_grtpu_does():
    """grtpu's LogPwrFft takes avg_alpha and builds no averaging stage
    (blocks/fftblk.py:90-118); the port keeps that behaviour."""
    r = np.random.RandomState(8)
    x = (r.randn(4096) + 1j * r.randn(4096)).astype(np.complex64)
    a = _logpwr("t", 1.0, x)
    for alpha in (0.1, 0.5):
        np.testing.assert_array_equal(_logpwr("t", alpha, x), a)
    np.testing.assert_allclose(_logpwr("j", 0.1, x), a, atol=2e-3)


# ------------------------------------------------------------ oscope
@pytest.mark.parametrize("mode", MODES)
def test_oscope_frames_equal_grtpu(mode):
    fs, f, n = 8000.0, 200.0, 4096
    x = np.sin(2 * np.pi * f * np.arange(n) / fs).astype(np.float32)
    scopes = {}
    for kind, m in (("j", josc), ("t", tosc)):
        scopes[kind] = m.OscopeSink(frame_size=128)
        run_block(kind, scopes[kind], [x], 1000,
                  mode if kind == "t" else "eager")
    for kw in (dict(level=0.0, slope="pos"), dict(level=0.5, slope="neg"),
               dict(level=5.0, mode="auto", max_frames=3)):
        got, want = scopes["t"].frames(**kw), scopes["j"].frames(**kw)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tosc.OscopeSink().frames() == []


def test_pubsub():
    ps = tosc.Pubsub()
    seen = []
    ps.subscribe("gain", seen.append)
    ps["gain"] = 10
    ps["gain"] = 20
    assert seen == [10, 20] and ps["gain"] == 20
    ps.publish("level", lambda: 42)
    assert ps["level"] == 42 and ps.keys() == {"gain", "level"}
    ps.unsubscribe("gain", seen.append)
    ps["gain"] = 30
    assert seen == [10, 20]


# ------------------------------------------------------------ selftest
def test_lfsr_words_identical_to_grtpu():
    np.testing.assert_array_equal(tself.lfsr_32k_words(),
                                  jself.lfsr_32k_words())
    np.testing.assert_array_equal(tself.lfsr_32k_words(5000),
                                  jself.lfsr_32k_words(5000))


@pytest.mark.parametrize("mode", MODES)
def test_lfsr_source_feeds_a_locked_checker(mode):
    reps = {}
    for kind, m in (("j", jself), ("t", tself)):
        pkg = PKG[kind]
        g = pkg.Graph()
        src, chk = m.Lfsr32kSource(), m.CheckLfsr32k()
        g.connect(src, chk)
        if kind == "j":
            pkg.StreamExecutor(g, chunk_size=1000, donate=False).run(steps=5)
        else:
            pkg.StreamExecutor(g, chunk_size=1000, device="cpu").run(
                steps=5, device_loop=mode == "device_loop")
        reps[kind] = chk.report()
        reps[kind + "x"] = chk._stream()
    assert reps["t"] == reps["j"]
    assert reps["t"]["nright"] == reps["t"]["ntotal"] == 5000
    np.testing.assert_array_equal(reps["tx"], reps["jx"])


def test_checkers_equal_grtpu_on_corrupted_streams():
    w = tself.lfsr_32k_words().astype(np.int64)
    stream = np.concatenate([w, w, w])
    stream[2500:2520] ^= 0x5A5A
    good = np.arange(5000, dtype=np.int64) & 0xFFFF
    bad = good.copy()
    bad[100] = 9999
    counts = np.arange(3000, dtype=np.int64)
    words = np.empty(6000, np.int64)
    words[0::2] = counts >> 16
    words[1::2] = counts & 0xFFFF
    for cls, kw, data in (("CheckLfsr32k", {}, stream),
                          ("CheckCounting", {}, good),
                          ("CheckCounting", {}, bad),
                          ("CheckCounting", {"do_32bit": True}, words)):
        t, j = getattr(tself, cls)(**kw), getattr(jself, cls)(**kw)
        t.captured = (torch.from_numpy(data.astype(np.int32)),)
        j.captured = (data.astype(np.int32),)
        assert t.report() == j.report()
    rep = tself.CheckLfsr32k()
    rep.captured = (torch.from_numpy(stream.astype(np.int32)),)
    r = rep.report()
    assert r["runlength"] > 2000
    assert r["ntotal"] - 2047 - 30 < r["nright"] < r["ntotal"]


# ------------------------------------------------------------ capturable steps
class NoHostRead:
    """Fails on any op that reads a tensor's value back to the host (an
    ``.item()``, ``bool(tensor)``, an index by a 0-d tensor): a CUDA graph
    capture of the step, as run(device_loop=True) makes, cannot hold one."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func)
                if "_local_scalar_dense" in name or "is_nonzero" in name \
                        or name.startswith("aten.item"):
                    raise AssertionError(f"host read in the step: {name}")
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        return self.mode.__enter__()

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _steps():
    from grtpu_torch import vocoder
    from grtpu_torch.models import noaa, pager

    r = np.random.RandomState(1)
    f = torch.from_numpy(r.randn(2048).astype(np.float32))
    c = torch.from_numpy((r.randn(2048) + 1j * r.randn(2048)).astype(
        np.complex64))
    u = torch.from_numpy(r.randint(0, 2, 2048).astype(np.uint8))
    s = torch.from_numpy((r.randn(1600) * 3000).astype(np.int16))
    return [
        ("CtcssSquelch", tmisc.CtcssSquelch(8000.0, 100.0, 0.005, 1024), [f]),
        ("DpllBB", tmisc.DpllBB(7.3, 0.2), [u[:300]]),
        ("IqComp", tmisc.IqComp(0.01), [c[:300]]),
        ("Threshold", tmisc.Threshold(-0.3, 0.3), [f]),
        ("StandardSquelch", tmisc.StandardSquelch(8000.0), [f]),
        ("Cpfsk", tmisc.Cpfsk(0.5, 1.0, 4), [u]),
        ("ErrorRate", tmisc.ErrorRate("BER", 50), [u, u.flip(0)]),
        ("ProbeDensity", tmisc.ProbeDensity(0.05), [u]),
        ("WaveletFF", tmisc.WaveletFF(16, 4), [f.reshape(-1, 16)]),
        ("FftVcc", tfft.FftVcc(16, True, np.hanning(16), True),
         [c.reshape(-1, 16)]),
        ("G721Encode", vocoder.G721Encode(), [s[:200]]),
        ("G721Decode", vocoder.G721Decode(), [u[:200]]),
        ("CvsdEncode", vocoder.CvsdEncode(), [s[:256]]),
        ("CvsdDecode", vocoder.CvsdDecode(), [u[:32]]),
        ("GsmFrEncode", vocoder.GsmFrEncode(), [s[:320]]),
        ("GsmFrDecode", vocoder.GsmFrDecode(),
         [torch.from_numpy(np.tile(np.array([0xD0] + [0] * 32, np.uint8),
                                   (2, 1)))]),
        ("HrptPll", noaa.HrptPll(), [c[:300]]),
        ("HrptDeframer", noaa.HrptDeframer(), [u]),
        ("PagerSlicer", pager.PagerSlicer(), [f]),
    ]


@pytest.mark.parametrize("idx", range(19))
def test_block_steps_read_nothing_back(idx):
    name, blk, xs = _steps()[idx]
    st = blk.init_state()
    with NoHostRead():
        st, _ = blk.apply(st, *xs)
        blk.apply(st, *xs)          # and again from the carried state


def test_tagger_and_source_steps_read_nothing_back():
    bt = tmisc.BurstTagger(0.5)
    mag = torch.tensor([0.0, 1, 1, 0, 1, 0], dtype=torch.float32)
    src = tself.Lfsr32kSource()
    with NoHostRead():
        st, _, rec = bt.apply_tagged(bt.init_state(), mag.to(torch.complex64),
                                     mag)
        bt.apply_tagged(st, mag.to(torch.complex64), mag)
        src.apply(src.apply(src.init_state(), 3000)[0], 3000)
    assert [t.offset for t in bt.tags_from_device(
        {k: v.numpy() for k, v in rec.items()}, 0, 0)] == [1, 3, 4, 5]
