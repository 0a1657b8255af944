"""grtpu_torch's OFDM stack held against grtpu on the CPU, at fft 64.

The scenarios of tests/test_ofdm.py: the burst modem (clean, noisy, CFO,
multipath), the frame-acquisition op, the four sync variants, the streaming
OfdmReceiver through both executors (the pn and ml variants, several frames
a chunk, frames completing mid-chunk), the BER parity of streaming and
burst receive, and the OFDM packet modem; plus what the port adds: the
suffix max's leftmost-index rule on an exact plateau, acquisition landing
within one window of a chunk's end, and checkpoints taken mid-frame that
resume bit for bit (eager, under device_loop, and across the packages).

Tolerances (grtpu's input, grtpu's own gates): bits, frame flags and
timing indices equal; the exported channel estimate within 1e-4 of
grtpu's, relative to its largest magnitude (float32 FFTs and glibc's sinf /
cosf against XLA's in the CFO derotation: the PR 7 class of difference);
the CFO within 1e-5 rad.  Every streaming case runs eagerly and under
``run(device_loop=True)``, which must give ``torch.equal`` outputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.digital import ofdm as jo  # noqa: E402
from grtpu_torch.digital import ofdm as to  # noqa: E402

CHAN_TOL = 1e-4
CFO_TOL = 1e-5
MODES = ["eager", "device_loop"]


def jm():
    return jo.OfdmModem()


def tm():
    return to.OfdmModem(device="cpu")


def chan_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def host(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


# ------------------------------------------------------------------ burst
def burst_signal(m, bits, seed, channel=None, pad=200, snr_db=None, cfo=0.0):
    rng = np.random.RandomState(seed)
    sig = m.modulate(bits)
    if channel is not None:
        sig = np.convolve(sig, channel)[: len(sig)]
    if cfo:
        sig = sig * np.exp(1j * cfo * np.arange(len(sig)))
    sig = np.concatenate([np.zeros(pad, np.complex64), sig,
                          np.zeros(pad, np.complex64)])
    if snr_db is not None:
        p = (np.abs(sig[pad:-pad]) ** 2).mean()
        n0 = p / 10 ** (snr_db / 10)
        sig = sig + (rng.randn(len(sig)) + 1j * rng.randn(len(sig))) * np.sqrt(n0 / 2)
    return sig.astype(np.complex64)


BURSTS = {  # name: (data symbols, signal keywords, BER gate)
    "clean": (6, {}, 0.001),
    "noisy": (6, {"snr_db": 15}, 0.01),
    "cfo": (6, {"cfo": 0.004, "snr_db": 25}, 0.01),
    "multipath": (6, {"channel": np.array([1.0, 0.0, 0.25 - 0.15j],
                                          np.complex64), "snr_db": 30}, 0.01),
}


@pytest.fixture(scope="module")
def grtpu_bursts():
    """grtpu's burst receive of each case, jitted once (every case has the
    same length)."""
    import jax

    out = {}
    m = jm()
    demod = jax.jit(m.demodulate, static_argnums=1)
    for i, (name, (nsym, kw, _)) in enumerate(BURSTS.items()):
        bits = np.random.RandomState(21 + i).randint(0, 2, nsym * 96).astype(np.uint8)
        sig = burst_signal(m, bits, 21 + i, **kw)
        got, chan, cfo, d = demod(jnp.asarray(sig), nsym)
        out[name] = (bits, sig, np.asarray(got), np.asarray(chan), float(cfo),
                     int(d))
    return out


@pytest.mark.parametrize("name", list(BURSTS))
def test_burst_modem_matches_grtpu(grtpu_bursts, name):
    """OfdmModem: the same burst (grtpu's bits and modulate) demodulates to
    grtpu's bits, timing and CFO, and the exported channel estimate agrees;
    the BER and channel gates of tests/test_ofdm.py hold."""
    nsym, kw, gate = BURSTS[name]
    bits, sig, jbits, jchan, jcfo, jd = grtpu_bursts[name]
    m = tm()
    np.testing.assert_array_equal(m.modulate(bits), jm().modulate(bits))
    got, chan, cfo, d = m.demodulate(sig, nsym)
    np.testing.assert_array_equal(got.numpy(), jbits)
    assert int(d) == jd
    assert abs(float(cfo) - jcfo) <= CFO_TOL
    assert chan_err(chan.numpy(), jchan) <= CHAN_TOL
    assert (got.numpy()[: len(bits)] != bits).mean() < gate
    if name == "clean":
        np.testing.assert_allclose(np.abs(chan.numpy()), 1.0, atol=0.1)
    if name == "cfo":
        assert abs(float(cfo) - 0.004) < 5e-4
    if name == "multipath":
        H = np.fft.fft(kw["channel"], m.fft_len)[m.bins]
        np.testing.assert_allclose(np.abs(chan.numpy()), np.abs(H), atol=0.15)


def test_frame_acquisition_op_and_carriers():
    """digital_ofdm_frame_acquisition: equalized known symbols recover the
    constellation; the same numbers as grtpu's op; the carrier layout skips
    DC."""
    m = tm()
    rng = np.random.RandomState(21)
    idx = rng.randint(0, 4, (3, m.occupied))
    sym = m.qpsk[idx]
    freq = np.zeros((4, m.fft_len), np.complex64)
    freq[0, m.bins] = m.known
    freq[1:, m.bins] = sym
    H = np.fft.fft(np.array([0.9, 0.1j, -0.05], np.complex64), m.fft_len)
    rx = (freq * H[None, :]).astype(np.complex64)
    eq, chan = to.ofdm_frame_acquisition(torch.from_numpy(rx),
                                         torch.from_numpy(m.known), m.bins)
    jeq, jchan = jo.ofdm_frame_acquisition(jnp.asarray(rx), jnp.asarray(m.known),
                                           m.bins)
    np.testing.assert_allclose(chan.numpy(), H[m.bins], atol=1e-4)
    np.testing.assert_allclose(eq.numpy(), sym, atol=1e-3)
    np.testing.assert_allclose(chan.numpy(), np.asarray(jchan), atol=1e-6)
    np.testing.assert_allclose(eq.numpy(), np.asarray(jeq), atol=1e-6)
    c = to.default_carriers(64, 48)
    np.testing.assert_array_equal(c, jo.default_carriers(64, 48))
    assert 0 not in c and len(c) == 48 and c.min() == -24 and c.max() == 24
    np.testing.assert_array_equal(to.carrier_bins(c, 64), jo.carrier_bins(c, 64))


# ------------------------------------------------------------------ sync
def sync_burst(cfo=0.002, snr_db=20.0, offset=300, seed=3):
    m = tm()
    rng = np.random.default_rng(seed)
    tx = m.modulate(rng.integers(0, 2, 96 * 4).astype(np.uint8))
    x = np.concatenate([np.zeros(offset, np.complex64), tx,
                        np.zeros(400, np.complex64)])
    x = x * np.exp(2j * np.pi * cfo * np.arange(len(x)))
    sigma = np.sqrt((np.abs(tx) ** 2).mean() / 10 ** (snr_db / 10) / 2)
    x = (x + sigma * (rng.standard_normal(len(x))
                      + 1j * rng.standard_normal(len(x)))).astype(np.complex64)
    return m, x, offset


@pytest.mark.parametrize("variant", ["pn", "ml", "pnac"])
def test_sync_variants_match_grtpu(variant):
    """TestSyncVariants: each metric and its CFO carrier agree with grtpu's
    (float32 prefix sums: 1e-4 of the peak), the peak lands where grtpu's
    does, and the timing and CFO gates of tests/test_ofdm.py hold."""
    cfo = 0.0005 if variant == "pnac" else 0.002
    m, x, offset = sync_burst(cfo=cfo, snr_db=25.0 if variant == "ml" else 20.0)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if variant == "pn":
        (met, P), (jmet, jP) = to.ofdm_sync_pn(xt, 64), jo.ofdm_sync_pn(xj, 64)
    elif variant == "ml":
        (met, P), (jmet, jP) = (to.ofdm_sync_ml(xt, 64, 16, 25.0),
                                jo.ofdm_sync_ml(xj, 64, 16, 25.0))
    else:
        (met, P), (jmet, jP) = (to.ofdm_sync_pnac(xt, 64, m.sync_time),
                                jo.ofdm_sync_pnac(xj, 64, m.sync_time))
    met, P, jmet, jP = met.numpy(), P.numpy(), np.asarray(jmet), np.asarray(jP)
    assert met.shape == jmet.shape and P.shape == jP.shape
    assert np.abs(met - jmet).max() <= 1e-4 * np.abs(jmet).max()
    assert np.abs(P - jP).max() <= 1e-4 * np.abs(jP).max()
    d = int(np.argmax(met))
    assert d == int(np.argmax(jmet))
    if variant == "pn":
        assert offset - 2 <= d <= offset + m.cp_len + 2
        cfo_hat = float(np.angle(P[d])) / 32
    elif variant == "ml":
        rel = (d - offset) % 80
        assert min(rel, 80 - rel) <= 3
        cfo_hat = -float(np.angle(P[d])) / 64
    else:
        assert abs(d - (offset + m.cp_len + 31)) <= 3
        cfo_hat = float(np.angle(P[d])) / 32
    assert abs(cfo_hat - 2 * np.pi * cfo) < (1e-3 if variant == "pnac" else 2e-3)


def test_sync_fixed_and_bounded_metric():
    peaks, freq = to.ofdm_sync_fixed(400, 64, 16, 3, freq_offset=0.01,
                                     device="cpu")
    jpeaks, jfreq = jo.ofdm_sync_fixed(400, 64, 16, 3, freq_offset=0.01)
    np.testing.assert_array_equal(peaks.numpy(), np.asarray(jpeaks))
    np.testing.assert_array_equal(freq.numpy(), np.asarray(jfreq))
    assert list(np.flatnonzero(peaks.numpy())[:2]) == [79, 319]
    # noise then silence: the symmetric normalization stays bounded by 1 at
    # the trailing edge and nothing reaches the threshold
    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(
        np.complex64)
    met, _ = to.ofdm_sync_pn(torch.from_numpy(
        np.concatenate([sig, np.zeros(512, np.complex64)])), 64)
    assert met.max() <= 1.0 + 1e-5 and met.max() < 0.5


def test_suffix_max_takes_the_leftmost_index_on_a_plateau():
    """The suffix max and its index.  The values are grtpu's.  The index is
    the leftmost argmax of met[i:], as grtpu's combine means it to be ("the
    leftmost max wins ties"), and is held to a numpy golden on metrics with
    exact plateaus.  grtpu's reverse associative_scan hands its combine the
    LATER segment as ``a``, so on exact ties it keeps the rightmost index (a
    fault of the reference, which reaches only the CFO read at d_pk on an
    exactly flat peak); away from ties the indices are grtpu's."""
    import jax

    @jax.jit
    def grtpu_rule(met):
        def comb(a, b):
            take_a = a[0] >= b[0]
            return (jnp.where(take_a, a[0], b[0]), jnp.where(take_a, a[1], b[1]))
        return jax.lax.associative_scan(
            comb, (met, jnp.arange(met.shape[0], dtype=jnp.int32)),
            reverse=True)

    rng = np.random.RandomState(4)
    n = 200                                 # one shape: one compile
    first = np.zeros(n, np.float32)
    first[:10] = [0, 1, 3, 3, 2, 3, 1, .5, .5, 0]
    plateaus = [first, np.full(n, 0.7, np.float32),
                rng.randint(0, 3, n).astype(np.float32),
                np.repeat(rng.rand(n // 5).astype(np.float32), 5)]
    for met in plateaus + [rng.rand(n).astype(np.float32)]:
        sm, arg = to.suffix_max(torch.from_numpy(met))
        jsm, jarg = grtpu_rule(met)
        np.testing.assert_array_equal(sm.numpy(), np.asarray(jsm))
        golden = [i + int(np.argmax(met[i:])) for i in range(len(met))]
        np.testing.assert_array_equal(arg.numpy(), golden)
        if len(np.unique(met)) == len(met):
            np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    _, jarg = grtpu_rule(plateaus[0])
    assert np.asarray(jarg)[0] == 5 and to.suffix_max(
        torch.from_numpy(plateaus[0]))[1][0] == 2


# ------------------------------------------------------------- streaming
def make_stream(nsym, nframes, snr, seed, cfo=0.002, gap=200, tail=1200):
    """Frames of ``nsym`` data symbols, each after ``gap`` zeros, with CFO
    and noise (examples/benchmark_ofdm.py's burst recipe)."""
    m = tm()
    rng = np.random.RandomState(seed)
    sigs, bits_all = [], []
    for _ in range(nframes):
        bits = rng.randint(0, 2, nsym * 96).astype(np.uint8)
        tx = m.modulate(bits)
        sig = np.concatenate([np.zeros(gap, np.complex64), tx])
        sig = sig * np.exp(1j * cfo * np.arange(len(sig)))
        n0 = (np.abs(tx) ** 2).mean() / 10 ** (snr / 10)
        sig = (sig + (rng.randn(len(sig)) + 1j * rng.randn(len(sig)))
               * np.sqrt(n0 / 2)).astype(np.complex64)
        sigs.append(sig)
        bits_all.append(bits)
    return np.concatenate(sigs + [np.zeros(tail, np.complex64)]).astype(
        np.complex64), bits_all


def rx_executor(kind, nsym, chunk, vr, sync="pn", snr_db=10.0):
    pkg, lib, o, m = ((grtpu, jnp, jo, jm()) if kind == "j"
                      else (grtpu_torch, torch, to, tm()))
    rx = o.OfdmReceiver(m, nsym_data=nsym, sync_type=sync, snr_db=snr_db)
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(lib.complex64))
    pb = g.add_output(pkg.Port(lib.uint8))
    pf = g.add_output(pkg.Port(lib.uint8))
    pc = g.add_output(pkg.Port(lib.complex64, m.occupied))
    g.connect(pin, rx)
    g.connect((rx, 0), o.OfdmFrameSink(m), pb)
    g.connect((rx, 1), pf)
    g.connect((rx, 2), pc)
    kw = {} if kind == "j" else {"device": "cpu"}
    return pkg.StreamExecutor(g, chunk_size=chunk, vr_chunks={rx: vr}, **kw)


SPAN = 8 * 80          # one frame span at nsym 6: (6 + 2) * 80
STREAMS = {  # name: (nsym, stream args, chunk, emission, sync)
    "two_frames": (6, (6, 2, 25.0, 5), 1024, 3, "pn"),
    "ml_variant": (4, (4, 1, 25.0, 6), 1024, 2, "ml"),
    "six_frames_mid_chunk": (8, (8, 6, 20.0, 200), 800, 8, "pn"),
    "frames_per_chunk": (6, (6, 4, 25.0, 7), 3000, 6, "pn"),
    "bench_chunk": (8, (8, 4, 20.0, 0), 4 * 800, 8, "pn"),
}


@pytest.fixture(scope="module")
def grtpu_streams():
    out = {}
    for name, (nsym, sargs, chunk, vr, sync) in STREAMS.items():
        x, bits = make_stream(*sargs)
        ex = rx_executor("j", nsym, chunk, vr, sync, 25.0)
        out[name] = tuple(np.asarray(y) for y in ex.run(jnp.asarray(x)))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(STREAMS))
def test_streaming_receiver_matches_grtpu(grtpu_streams, name, mode):
    """OfdmReceiver -> OfdmFrameSink through the executor: the bits and
    frame flags equal grtpu's, the channel estimate port agrees, every
    frame is found with BER 0; device_loop equals the eager run."""
    nsym, sargs, chunk, vr, sync = STREAMS[name]
    x, bits_all = make_stream(*sargs)
    ex = rx_executor("t", nsym, chunk, vr, sync, 25.0)
    ys = ex.run(x, device_loop=mode == "device_loop")
    jb, jf, jc = grtpu_streams[name]
    np.testing.assert_array_equal(ys[0].numpy(), jb)
    np.testing.assert_array_equal(ys[1].numpy(), jf)
    assert chan_err(ys[2].numpy(), jc) <= CHAN_TOL
    per = nsym * 96
    assert len(jb) // per == len(bits_all) == int(ys[1].sum())
    for i, b in enumerate(bits_all):
        assert (ys[0].numpy()[i * per:(i + 1) * per] != b).mean() == 0.0
    if mode == "device_loop":
        ref = rx_executor("t", nsym, chunk, vr, sync, 25.0).run(x)
        assert all(torch.equal(a, b) for a, b in zip(ys, ref))


@pytest.mark.parametrize("lead", [0, 17, 40, 63])
def test_acquisition_near_the_chunk_end(lead):
    """A sync preamble that lands within one FFT window of a chunk's end
    (the clamped windows of the acquisition and the frame gather sit at
    the chunk's edge): the frame is found in the next chunk, bits equal to
    grtpu's, none lost."""
    nsym, chunk = 6, 1024
    m = tm()
    rng = np.random.RandomState(30 + lead)
    bits = rng.randint(0, 2, nsym * 96).astype(np.uint8)
    tx = m.modulate(bits) * np.exp(1j * 0.001 * np.arange(8 * 80))
    start = chunk - (2 * 80 + 64) + lead        # the metric's search limit
    x = np.concatenate([np.zeros(start, np.complex64), tx,
                        np.zeros(2 * chunk, np.complex64)]).astype(np.complex64)
    x = x[: len(x) // chunk * chunk]
    got = rx_executor("t", nsym, chunk, nsym).run(x)
    ref = rx_executor("j", nsym, chunk, nsym).run(jnp.asarray(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[0].numpy(), bits)
    assert chan_err(got[2].numpy(), np.asarray(ref[2])) <= CHAN_TOL


def test_streaming_ber_tracks_the_burst_modem():
    """TestBerCurveParity: at 10 dB the streaming receiver's BER on each
    frame is within 0.01 of the burst modem's on the same waveform."""
    nsym = 6
    m = tm()
    rng = np.random.RandomState(10)
    sigs, bits_all, bers = [], [], []
    for _ in range(2):
        bits = rng.randint(0, 2, nsym * 96).astype(np.uint8)
        tx = m.modulate(bits)
        sig = np.concatenate([np.zeros(200, np.complex64), tx])
        sig = sig * np.exp(1j * 0.002 * np.arange(len(sig)))
        n0 = (np.abs(tx) ** 2).mean() / 10
        sig = (sig + (rng.randn(len(sig)) + 1j * rng.randn(len(sig)))
               * np.sqrt(n0 / 2)).astype(np.complex64)
        got = m.demodulate(sig, nsym)[0].numpy()
        bers.append((got[: len(bits)] != bits).mean())
        sigs.append(sig)
        bits_all.append(bits)
    stream = np.concatenate(sigs + [np.zeros(1200, np.complex64)])
    out = rx_executor("t", nsym, SPAN, nsym).run(stream)[0].numpy()
    per = nsym * 96
    assert len(out) // per == 2
    for i in range(2):
        assert abs((out[i * per:(i + 1) * per] != bits_all[i]).mean()
                   - bers[i]) <= 0.01


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("writer,reader", [("t", "t"), ("j", "t"), ("t", "j")])
def test_mid_frame_checkpoint_resumes_bit_for_bit(tmp_path, writer, reader):
    """A checkpoint taken with a frame half received (state chan, cfo_phase,
    anchor, sym_left mid-frame) resumes bit for bit: in the port eagerly and
    under device_loop, and across the packages both ways."""
    nsym, chunk = 8, 400
    x, _ = make_stream(nsym, 3, 20.0, 41)
    x = x[: len(x) // chunk * chunk]
    full = rx_executor("t", nsym, chunk, nsym).run(x)

    def rx_state(ex):
        return next(v for v in ex.state["blocks"].values() if isinstance(v, dict))

    probe = rx_executor("t", nsym, chunk, nsym)
    for c in range(len(x) // chunk):       # the first chunk that ends mid-frame
        probe.run(x[c * chunk:(c + 1) * chunk])
        if 0 < int(rx_state(probe)["sym_left"]) < nsym:
            break
    cut = (c + 1) * chunk
    ex = rx_executor(writer, nsym, chunk, nsym)
    first = ex.run(x[:cut] if writer == "t" else jnp.asarray(x[:cut]))
    st = rx_state(ex)
    assert 0 < int(st["sym_left"]) < nsym and bool(st["have"])
    path = str(tmp_path / "ofdm.npz")
    ex.save_checkpoint(path)
    modes = ["eager", "device_loop"] if reader == "t" else ["eager"]
    for mode in modes:
        ex2 = rx_executor(reader, nsym, chunk, nsym)
        ex2.load_checkpoint(path)
        if reader == "t":
            rest = ex2.run(x[cut:], device_loop=mode == "device_loop")
        else:
            rest = ex2.run(jnp.asarray(x[cut:]))
        bits = np.concatenate([host(first[0]), host(rest[0])])
        np.testing.assert_array_equal(bits, full[0].numpy())
        flags = np.concatenate([host(first[1]), host(rest[1])])
        np.testing.assert_array_equal(flags, full[1].numpy())


# ---------------------------------------------------------- packet modem
@pytest.fixture(scope="module")
def packet_streams():
    """TestOfdmPacketModem's streams: three packets (one at the frame's
    capacity) at 20 dB with a small CFO, and one frame with two data
    symbols smashed."""
    m = tm()
    pm = to.OfdmPacketModem(m, 8)
    rng = np.random.default_rng(5)
    payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for n in (11, pm.max_payload, 40)]
    sigs = [np.concatenate([np.zeros(150, np.complex64),
                            pm.make_burst(p, whitener_offset=i % 16)])
            for i, p in enumerate(payloads)]
    stream = np.concatenate(sigs + [np.zeros(1500, np.complex64)])
    n = len(stream)
    stream = stream * np.exp(2j * np.pi * 1.5e-4 * np.arange(n))
    rng2 = np.random.default_rng(6)
    sigma = np.sqrt((np.abs(np.concatenate(sigs)) ** 2).mean() / 100 / 2)
    good = (stream + sigma * (rng2.standard_normal(n)
                              + 1j * rng2.standard_normal(n))).astype(np.complex64)
    burst = pm.make_burst(b"hello ofdm packet layer")
    burst[3 * 80: 5 * 80] = 0.3 + 0.1j
    bad = np.concatenate([np.zeros(120, np.complex64), burst,
                          np.zeros(2500, np.complex64)]).astype(np.complex64)
    return payloads, good, bad


@pytest.mark.parametrize("mode", MODES)
def test_ofdm_packet_modem_matches_grtpu(packet_streams, mode):
    """make_burst is grtpu's burst; through the receiver to parse_frames
    every CRC passes and the payloads come back; a smashed frame fails its
    CRC and is counted; an oversized payload is refused."""
    payloads, good, bad = packet_streams
    pm, jpm = to.OfdmPacketModem(tm(), 8), jo.OfdmPacketModem(jm(), 8)
    assert pm.max_payload == jpm.max_payload == (8 * 48 * 2) // 8 - 8
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(pm.make_burst(p, i % 16),
                                      jpm.make_burst(p, i % 16))
    res = {}
    for name, x in (("good", good), ("bad", bad)):
        bits, flags, _ = rx_executor("t", 8, 4 * 800, 8).run(
            x, device_loop=mode == "device_loop")
        res[name] = pm.parse_frames(bits, flags)
        assert res[name] == jpm.parse_frames(bits.numpy(), flags.numpy())
    assert res["good"] == [(True, p) for p in payloads]
    assert len(res["bad"]) >= 1 and not res["bad"][0][0]
    with pytest.raises(ValueError, match="capacity"):
        to.OfdmPacketModem(tm(), 4).make_burst(b"x" * (pm.max_payload // 2 + 1))
