"""The FM family of grtpu_torch.models.fm against grtpu.models.fm on the CPU,
and BASELINE config #1 as a whole: frequency-translating tuner -> WBFM
receiver.

Each model runs as a graph through both packages' executors on the same
numpy-made IQ or audio, at two chunk sizes.  Tolerance on max|diff| /
max|grtpu|: 1e-5 for chains of float32 matmul FIRs and elementwise blocks;
2e-4 absolute where the chain holds a float32 prefix sum (the FM modulators'
phase, AmDemod's 1,024-sample DC blocker), the bound grtpu's own
chunk-invariance test uses (tests/test_fm_models.py:70-86); 1e-4 where the
audio FIR runs on the kernel path at bf16x3.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _exact_rotator  # noqa: E402
import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import filter as jfilt  # noqa: E402
from grtpu.models import fm as jfm  # noqa: E402
from grtpu.ops import pallas_fir as jpf  # noqa: E402
from grtpu_torch.blocks import filter as tfilt  # noqa: E402
from grtpu_torch.models import fm as tfm  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

FS = 2.048e6
QUAD = 256e3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _pkg(kind):
    return (grtpu, jnp, jfm, jfilt) if kind == "j" else \
        (grtpu_torch, torch, tfm, tfilt)


def run_chain(kind, make, x, chunk, in_c=True, n_out=1, out_c=False,
              executor=False):
    pkg, lib, fm, filt = _pkg(kind)
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(lib.complex64 if in_c else lib.float32))
    chain = make(fm, filt)
    out_dt = lib.complex64 if out_c else lib.float32
    if n_out == 1:
        g.connect(pin, *chain, g.add_output(pkg.Port(out_dt)))
    else:
        g.connect(pin, *chain)
        for i in range(n_out):
            g.connect((chain[-1], i), g.add_output(pkg.Port(out_dt)))
    kw = {} if kind == "j" else {"device": "cpu"}
    ex = pkg.StreamExecutor(g, chunk_size=chunk, **kw)
    if executor:
        return ex
    y = ex.run(jnp.asarray(x) if kind == "j" else x)
    y = y if isinstance(y, tuple) else (y,)
    y = tuple(np.asarray(v) if kind == "j" else v.numpy() for v in y)
    return y[0] if n_out == 1 else y


def wideband_capture(n, seed=0):
    """Two FM stations in a 2.048 MS/s capture: a 1 kHz tone at 75 kHz
    deviation at +400 kHz and a stronger one at -300 kHz, plus noise."""
    t = np.arange(n) / FS
    def station(f_audio, offset, amp):
        ph = 75e3 / f_audio * np.sin(2 * np.pi * f_audio * t) * 0.5
        return amp * np.exp(1j * (2 * np.pi * offset * t + ph))
    r = np.random.RandomState(seed)
    x = station(1000.0, 400e3, 1.0) + station(2500.0, -300e3, 3.0)
    return (x + 0.01 * (r.randn(n) + 1j * r.randn(n))).astype(np.complex64)


def tuner_wfm(fm, filt, impl=None):
    taps = firdes.low_pass(1.0, FS, 100e3, 50e3)
    tuner = filt.FreqXlatingFirFilter(8, taps, 400e3, FS)
    if impl is None:
        return [tuner, fm.WfmRcv(QUAD, 8)]
    return [tuner, fm.WfmRcv(QUAD, 8, impl=impl)]


def fm_iq(n, rate, dev, f=1000.0, seed=0):
    t = np.arange(n) / rate
    ph = np.cumsum(2 * np.pi * dev / rate * 0.5 * np.sin(2 * np.pi * f * t))
    r = np.random.RandomState(seed)
    return (np.exp(1j * ph) + 0.01 * (r.randn(n) + 1j * r.randn(n))
            ).astype(np.complex64)


# ------------------------------------------------- config #1: tuner -> WBFM
@pytest.mark.parametrize("chunk", [8192, 16384])
def test_tuner_wfm_rcv_matches_grtpu(chunk, monkeypatch):
    """Held to grtpu with its rotator's float32 ramp (to 2e4 rad at chunk
    16,384) reduced before rounding (``_exact_rotator``)."""
    _exact_rotator.install(monkeypatch)
    x = wideband_capture(1 << 15)
    ref = run_chain("j", tuner_wfm, x, chunk)
    got = run_chain("t", tuner_wfm, x, chunk)
    assert got.shape == (1 << 9,)
    assert rel(got, ref) < 1e-5


def test_tuner_wfm_rcv_recovers_the_tuned_station():
    """The station at +400 kHz (1 kHz tone) comes out, the stronger one at
    -300 kHz (2.5 kHz tone) does not."""
    audio = run_chain("t", tuner_wfm, wideband_capture(1 << 17), 16384)
    seg = audio[256:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg)))) ** 2
    freqs = np.fft.rfftfreq(len(seg), 8 * 8 / FS)
    def band(f):
        return spec[(freqs > f - 150) & (freqs < f + 150)].sum()
    assert band(1000.0) > 1e3 * band(2500.0)


def test_tuner_wfm_rcv_kernel_path_matches_grtpu_pallas(monkeypatch):
    """The audio FIR on the kernel path (the port's twin on the CPU, grtpu's
    Pallas kernel in interpret mode), behind the tuner."""
    monkeypatch.setattr(jpf, "fir_decim", functools.partial(
        jpf.fir_decim, interpret=True, precision="bf16x3", tile_rows=256))
    x = wideband_capture(1 << 15, seed=1)

    def jax_chain(fm, filt):
        chain = tuner_wfm(fm, filt)
        rcv = chain[1]
        # grtpu's WfmRcv takes no impl: swap its audio filter's path
        rcv.audio_filter.impl = "pallas"
        return chain

    ref = run_chain("j", jax_chain, x, 8192)
    got = run_chain("t", functools.partial(tuner_wfm, impl="kernel"), x, 8192)
    assert rel(got, ref) < 1e-4
    plain = run_chain("t", tuner_wfm, x, 8192)
    assert rel(got, plain) < 1e-4


@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")],
                         ids=["grtpu-to-port", "port-to-grtpu"])
def test_tuner_wfm_rcv_checkpoint_moves_between_packages(tmp_path, writer,
                                                         reader, monkeypatch):
    """Stopped mid-stream in one package and resumed in the other (the
    rotator's phase, the halo tails, the de-emphasis state), the graph
    equals the uninterrupted run.  grtpu runs with its rotator's ramp
    reduced before rounding (``_exact_rotator``), as the port's is."""
    _exact_rotator.install(monkeypatch)
    chunk = 8192
    x = wideband_capture(4 * chunk, seed=2)
    half = 2 * chunk

    def run(ex, kind, v):
        y = ex.run(jnp.asarray(v) if kind == "j" else v)
        return np.asarray(y) if kind == "j" else y.numpy()

    full = run(run_chain(writer, tuner_wfm, None, chunk, executor=True),
               writer, x)
    first = run_chain(writer, tuner_wfm, None, chunk, executor=True)
    run(first, writer, x[:half])
    path = str(tmp_path / "tuner.npz")
    first.save_checkpoint(path)
    second = run_chain(reader, tuner_wfm, None, chunk, executor=True)
    second.load_checkpoint(path)
    tail = run(second, reader, x[half:])
    assert rel(tail, full[half // 64:]) < 1e-5
    # the rotator phase is a leaf of the checkpoint, under grtpu's path
    paths = [str(p) for p in np.load(path)["__paths__"]]
    assert any("FreqXlatingFirFilter" in p and p.startswith("blocks/")
               for p in paths)


# ----------------------------------------------------------- the FM family
RECEIVERS = {
    "NbfmRx": (lambda fm, filt: [fm.NbfmRx(16e3, 64e3)], 64e3, 5e3, 4),
    "WfmRcvFmdet": (lambda fm, filt: [fm.WfmRcvFmdet(QUAD, 8)], QUAD, 75e3, 8),
    "FmDemod": (lambda fm, filt: [fm.FmDemod(64e3, 4, 5e3, 3e3, 4.5e3)],
                64e3, 5e3, 4),
    "FmDemod_no_deemph": (lambda fm, filt: [fm.FmDemod(
        64e3, 4, 5e3, 3e3, 4.5e3, gain=2.0, tau=None)], 64e3, 5e3, 4),
    "Demod20k0f3e": (lambda fm, filt: [fm.Demod20k0f3e(64e3, 4)], 64e3, 5e3, 4),
    "Demod200kf3e": (lambda fm, filt: [fm.Demod200kf3e(QUAD, 8)], QUAD, 75e3, 8),
}


@pytest.mark.parametrize("chunk", [2048, 8192])
@pytest.mark.parametrize("name", list(RECEIVERS))
def test_fm_receivers_match_grtpu(name, chunk):
    make, rate, dev, decim = RECEIVERS[name]
    x = fm_iq(1 << 14, rate, dev, seed=3)
    ref = run_chain("j", make, x, chunk)
    got = run_chain("t", make, x, chunk)
    assert got.shape == ((1 << 14) // decim,)
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("name", ["NbfmRx", "WfmRcvFmdet"])
def test_receivers_on_the_kernel_path(name):
    """NbfmRx and WfmRcvFmdet built with impl='kernel' (bf16x3) stay within
    1e-4 of their float32 selves."""
    make, rate, dev, _ = RECEIVERS[name]
    cls = getattr(tfm, name)
    args = (16e3, 64e3) if name == "NbfmRx" else (QUAD, 8)
    x = fm_iq(1 << 14, rate, dev, seed=4)
    plain = run_chain("t", make, x, 4096)
    got = run_chain("t", lambda fm, filt: [cls(*args, impl="kernel")], x, 4096)
    assert rel(got, plain) < 1e-4


TRANSMITTERS = {
    "NbfmTx": (lambda fm, filt: [fm.NbfmTx(16e3, 64e3)], 4),
    "NbfmTx_unity": (lambda fm, filt: [fm.NbfmTx(16e3, 16e3)], 1),
    "WfmTx": (lambda fm, filt: [fm.WfmTx(32e3, QUAD)], 8),
    "WfmTx_unity": (lambda fm, filt: [fm.WfmTx(32e3, 32e3)], 1),
}


@pytest.mark.parametrize("chunk", [1024, 4096])
@pytest.mark.parametrize("name", list(TRANSMITTERS))
def test_fm_transmitters_match_grtpu(name, chunk):
    """The modulator's phase is a float32 prefix sum over each chunk:
    2e-4 absolute on the unit circle at 4,096-sample chunks x interpolation
    (torch sums float32 in float64 on a CPU)."""
    make, interp = TRANSMITTERS[name]
    t = np.arange(4096) / 16e3
    msg = (0.5 * np.sin(2 * np.pi * 800 * t)).astype(np.float32)
    ref = run_chain("j", make, msg, chunk, in_c=False, out_c=True)
    got = run_chain("t", make, msg, chunk, in_c=False, out_c=True)
    assert got.shape == (4096 * interp,)
    np.testing.assert_allclose(got, ref, atol=2e-4 * max(1, interp // 2))


@pytest.mark.parametrize("chunk", [2048, 4096])
def test_nbfm_loopback_matches_grtpu(chunk):
    """NbfmTx -> NbfmRx (tests/test_fm_models.py:89-116): the two packages
    agree, and the 800 Hz tone comes back dominant and in band."""
    make = lambda fm, filt: [fm.NbfmTx(16e3, 64e3), fm.NbfmRx(16e3, 64e3)]  # noqa: E731
    n = 1 << 14
    msg = (0.5 * np.sin(2 * np.pi * 800 * np.arange(n) / 16e3)
           ).astype(np.float32)
    ref = run_chain("j", make, msg, chunk, in_c=False)
    got = run_chain("t", make, msg, chunk, in_c=False)
    assert got.shape == (n,)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    seg = got[2048:2048 + 8192]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * 16e3 / len(seg) - 800) < 10
    inband = spec[np.arange(len(spec)) * 16e3 / len(seg) < 3000]
    assert inband.sum() / spec.sum() > 0.95


@pytest.mark.parametrize("chunk", [2048, 4096])
def test_am_demod_matches_grtpu(chunk):
    """Magnitude -> 1,024-sample moving-average DC blocker -> audio FIR: the
    blocker's prefix sums over chunk + 1,535 samples of a unit carrier bound
    the difference at 2e-4 absolute."""
    n = 1 << 14
    t = np.arange(n) / 64e3
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 1000 * t)
    r = np.random.RandomState(5)
    x = (env * np.exp(0.3j) + 0.01 * (r.randn(n) + 1j * r.randn(n))
         ).astype(np.complex64)
    make = lambda fm, filt: [fm.AmDemod(64e3, 4)]  # noqa: E731
    ref = run_chain("j", make, x, chunk)
    got = run_chain("t", make, x, chunk)
    assert got.shape == (n // 4,)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    seg = got[1024:]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * 16e3 / len(seg) - 1000) < 20


def stereo_iq(n):
    t = np.arange(n) / QUAD
    left = 0.4 * np.sin(2 * np.pi * 700 * t)
    right = 0.4 * np.sin(2 * np.pi * 2200 * t)
    pilot = 0.1 * np.sin(2 * np.pi * 19000 * t)
    sub = (left - right) * np.sin(2 * np.pi * 38000 * t)
    composite = (left + right) / 2 + pilot + sub / 2
    ph = np.cumsum(2 * np.pi * 75e3 / QUAD * composite)
    return np.exp(1j * ph).astype(np.complex64)


@pytest.mark.parametrize("chunk", [4096, 8192])
def test_wfm_rcv_pll_matches_grtpu(chunk):
    """The stereo receiver (eleven blocks, two outputs): both channels agree
    with grtpu's, and left/right separate as in grtpu's own test
    (tests/test_pager_misc.py:407-440)."""
    n = 1 << 15
    x = stereo_iq(n)
    make = lambda fm, filt: [fm.WfmRcvPll(QUAD, 8)]  # noqa: E731
    ref = run_chain("j", make, x, chunk, n_out=2)
    got = run_chain("t", make, x, chunk, n_out=2)
    for r, g in zip(ref, got):
        assert g.shape == (n // 8,)
        assert rel(g, r) < 1e-5
    L, R = got[0][2000:], got[1][2000:]

    def band_power(sig, f):
        spec = np.abs(np.fft.rfft(sig * np.hanning(len(sig)))) ** 2
        freqs = np.fft.rfftfreq(len(sig), 8 / QUAD)
        return spec[(freqs > f - 100) & (freqs < f + 100)].sum()

    assert band_power(L, 700) > 4 * band_power(L, 2200)
    assert band_power(R, 2200) > 4 * band_power(R, 700)


@pytest.mark.parametrize("name", ["FmPreemph", "FmDeemph"])
def test_emphasis_filters_match_grtpu(name):
    x = (0.3 * np.random.RandomState(6).randn(4096)).astype(np.float32)
    make = lambda fm, filt: [getattr(fm, name)(32e3)]  # noqa: E731
    ref = run_chain("j", make, x, 1024, in_c=False)
    got = run_chain("t", make, x, 1024, in_c=False)
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")],
                         ids=["grtpu-to-port", "port-to-grtpu"])
def test_preemph_state_moves_between_packages(tmp_path, writer, reader):
    """FmPreemph's IIR state (x and y histories) under grtpu's leaf paths."""
    x = (0.3 * np.random.RandomState(7).randn(2048)).astype(np.float32)
    make = lambda fm, filt: [fm.FmPreemph(32e3)]  # noqa: E731

    def run(ex, kind, v):
        y = ex.run(jnp.asarray(v) if kind == "j" else v)
        return np.asarray(y) if kind == "j" else y.numpy()

    def ex(kind):
        return run_chain(kind, make, None, 512, in_c=False, executor=True)

    full = run(ex(writer), writer, x)
    first = ex(writer)
    run(first, writer, x[:1024])
    path = str(tmp_path / "pre.npz")
    first.save_checkpoint(path)
    second = ex(reader)
    second.load_checkpoint(path)
    assert rel(run(second, reader, x[1024:]), full[1024:]) < 1e-5


def test_models_package_exports():
    import grtpu.models as jm
    import grtpu_torch.blocks as tb
    import grtpu_torch.models as tm

    for name in ("AmDemod", "FmDeemph", "FmPreemph", "NbfmRx", "NbfmTx",
                 "WfmRcv", "WfmTx"):
        assert hasattr(jm, name) and hasattr(tm, name)
    for name in ("analog", "convert", "filter", "gengen", "pfb", "stream"):
        assert hasattr(tb, name)
    with pytest.raises(ValueError):
        tfm.NbfmRx(16e3, 50e3)


def test_tuner_snr_is_the_chains_own_on_chip_smokes_capture(monkeypatch):
    """chip_smoke's phase 6a reads 39.32 dB of audio SNR on the tuner path
    against 57.58 on the main path.  On a shortened capture of the same
    recipe (chip_smoke.wideband_capture, 2^18 samples) grtpu (its rotator's
    ramp reduced before rounding, ``_exact_rotator``) and the port give the
    same audio (1e-5) and so the same SNR: the figure is the chain's, not a
    fault of the port.  It is the reference's sampling that
    sets it: after the tuner's decimation by 8 the discriminator measures
    the phase step over 8 capture samples, centred 3.5 samples before the
    capture grid the reference is taken on; against the message as the
    discriminator measures it (chip_smoke.discriminator_message) both
    packages read the main path's ~57.6 dB."""
    import importlib.util
    from pathlib import Path

    _exact_rotator.install(monkeypatch)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    x, msg = cs.wideband_capture(n=1 << 18)
    audio = {k: run_chain(k, tuner_wfm, x, 65536) for k in ("j", "t")}
    assert rel(audio["t"], audio["j"]) < 1e-5

    taps = firdes.low_pass(1.0, FS, 100e3, 50e3)
    first = -((len(taps) - 1) // 2) % 64

    def snr(y, m):
        ref = run_chain("t", lambda fm, filt: [fm.FmDeemph(QUAD / 8, 75e-6)],
                        m[first::64], 8192, in_c=False)
        r, e = cs.align(ref[512:-512], y[512:-512])
        return cs.snr_db(r.astype(np.float64), e.astype(np.float64))

    on_grid = {k: snr(y, msg) for k, y in audio.items()}
    measured = {k: snr(y, cs.discriminator_message(msg))
                for k, y in audio.items()}
    assert abs(on_grid["t"] - on_grid["j"]) < 0.01
    assert abs(measured["t"] - measured["j"]) < 0.01
    assert 38.8 < on_grid["t"] < 39.8
    assert measured["t"] > 55.0
