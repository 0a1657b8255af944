"""The WBFM receive slice as a whole, grtpu_torch against grtpu on the CPU.

North-star config #1: quadrature demod -> 8x decimating audio FIR ->
de-emphasis.  The IQ input is made in numpy (float64 phase) so both
packages see identical samples.  Tolerances on max|diff| / max|grtpu|:
1e-5 for the float32 (mxu) chain, 1e-4 where the FIR runs at the kernels'
bf16x3 default (grtpu's ``impl='pallas'`` in interpret mode, the port's
``impl='kernel'`` twin on the CPU).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.ops import pallas_fir as jpf  # noqa: E402
from grtpu.models import fm as jfm  # noqa: E402
from grtpu.blocks import analog as janalog, filter as jfilt  # noqa: E402
from grtpu_torch.models import fm as tfm  # noqa: E402
from grtpu_torch.blocks import analog as tanalog, filter as tfilt  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

QUAD = 256_000.0
DECIM = 8
N = 1 << 14


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def tone_iq(n, f=1000.0, seed=0):
    """WBFM IQ of a 1 kHz tone at 75 kHz deviation, plus a little noise."""
    t = np.arange(n) / QUAD
    msg = 0.5 * np.sin(2 * np.pi * f * t)
    phase = np.cumsum(2 * np.pi * 75e3 / QUAD * msg)
    noise = 0.01 * np.random.RandomState(seed).randn(2, n)
    return (np.exp(1j * phase) + noise[0] + 1j * noise[1]).astype(np.complex64)


def graph(kind, chain, in_c=True):
    pkg = grtpu if kind == "jax" else grtpu_torch
    lib = jnp if kind == "jax" else torch
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(lib.complex64 if in_c else lib.float32))
    pout = g.add_output(pkg.Port(lib.float32))
    g.connect(pin, *chain, pout)
    return g


def cpu(pkg):
    """Keyword that keeps a grtpu_torch entry point on the CPU (its default
    device is the card); grtpu takes no such argument."""
    return {"device": "cpu"} if pkg is grtpu_torch else {}


def run(kind, g, x, chunk):
    pkg = grtpu if kind == "jax" else grtpu_torch
    y = pkg.StreamExecutor(g, chunk_size=chunk, **cpu(pkg)).run(
        jnp.asarray(x) if kind == "jax" else x)
    return np.asarray(y) if kind == "jax" else y.numpy()


def audio_taps():
    ar = QUAD / DECIM
    return firdes.low_pass(1.0, QUAD, ar / 2 - 1e3, ar / 10,
                           firdes.Window.HAMMING)


def test_wfm_rcv_matches_grtpu():
    iq = tone_iq(N)
    ref = run("jax", graph("jax", [jfm.WfmRcv(QUAD, DECIM)]), iq, 4096)
    got = run("torch", graph("torch", [tfm.WfmRcv(QUAD, DECIM)]), iq, 4096)
    assert got.shape == (N // DECIM,)
    assert rel(got, ref) < 1e-5


def test_kernel_graph_matches_grtpu_pallas_graph(monkeypatch):
    """The slice with its FIR on the kernel path: the port's
    FirFilter(impl='kernel') against grtpu's FirFilter(impl='pallas')."""
    monkeypatch.setattr(jpf, "fir_decim", functools.partial(
        jpf.fir_decim, interpret=True, precision="bf16x3", tile_rows=256))
    iq = tone_iq(N, seed=1)
    gain = QUAD / (2 * np.pi * 75e3)
    taps = audio_taps()
    ref = run("jax", graph("jax", [
        janalog.QuadratureDemod(gain),
        jfilt.FirFilter(DECIM, taps, "fff", impl="pallas"),
        jfm.FmDeemph(QUAD / DECIM)]), iq, 4096)
    got = run("torch", graph("torch", [
        tanalog.QuadratureDemod(gain),
        tfilt.FirFilter(DECIM, taps, "fff", impl="kernel"),
        tfm.FmDeemph(QUAD / DECIM)]), iq, 4096)
    assert rel(got, ref) < 1e-4
    plain = run("torch", graph("torch", [tfm.WfmRcv(QUAD, DECIM)]), iq, 4096)
    assert rel(got, plain) < 1e-4


def snr_db(ref, est):
    err = est - ref
    return 10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1e-30))


def align(ref, est, max_lag=256):
    n = min(len(ref), len(est))
    r, e = ref[:n], est[:n]
    corr = [np.dot(r[: n - lag], e[lag:n]) for lag in range(max_lag)]
    lag = int(np.argmax(corr))
    return r[: n - lag], e[lag:n]


@pytest.mark.parametrize("impl", ["mxu", "kernel"])
def test_tone_recovery_snr(impl):
    """FM-modulate a 1 kHz tone through the port's own FrequencyModulator
    and recover it (tests/test_fm_models.py:35-68): SNR > 30 dB."""
    n = 1 << 16
    t = np.arange(n) / QUAD
    msg = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    mod = tanalog.FrequencyModulator(2 * np.pi * 75e3 / QUAD)
    if impl == "mxu":
        chain = [mod, tfm.WfmRcv(QUAD, DECIM)]
    else:
        chain = [mod, tanalog.QuadratureDemod(QUAD / (2 * np.pi * 75e3)),
                 tfilt.FirFilter(DECIM, audio_taps(), "fff", impl="kernel"),
                 tfm.FmDeemph(QUAD / DECIM)]
    audio = run("torch", graph("torch", chain, in_c=False), msg, 8192)
    assert audio.shape == (n // DECIM,)
    ref = run("torch", graph("torch", [tfm.FmDeemph(QUAD / DECIM)], in_c=False),
              msg[::DECIM], 1024)
    r, e = align(ref[512:-512], audio[512:-512])
    assert snr_db(r, e) > 30.0


def test_chunk_size_invariance():
    iq = tone_iq(1 << 13, seed=2)
    outs = [run("torch", graph("torch", [tfm.WfmRcv(64_000.0, 4)]), iq, cs)
            for cs in (1024, 4096)]
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-4)


def test_deemph_and_modulator_match_grtpu():
    rng = np.random.RandomState(3)
    x = (0.3 * rng.randn(4096)).astype(np.float32)
    ref = run("jax", graph("jax", [jfm.FmDeemph(32000.0)], in_c=False), x, 1024)
    got = run("torch", graph("torch", [tfm.FmDeemph(32000.0)], in_c=False),
              x, 1024)
    assert rel(got, ref) < 1e-5
    # modulator -> discriminator round trip recovers the message in both
    sens = 0.5
    chain = {k: [m.FrequencyModulator(sens), m.QuadratureDemod(1 / sens)]
             for k, m in (("jax", janalog), ("torch", tanalog))}
    a = run("jax", graph("jax", chain["jax"], in_c=False), x, 1024)
    b = run("torch", graph("torch", chain["torch"], in_c=False), x, 1024)
    np.testing.assert_allclose(b[1:], x[1:], atol=1e-4)
    np.testing.assert_allclose(b, a, atol=1e-4)


class TestCheckpointAcrossPackages:
    """A WBFM flowgraph checkpointed mid-stream by one package resumes in
    the other: 2 chunks + checkpoint + 2 chunks == one 4-chunk run."""

    CHUNK = 4096

    def _ex(self, kind):
        m = jfm if kind == "jax" else tfm
        pkg = grtpu if kind == "jax" else grtpu_torch
        return pkg.StreamExecutor(graph(kind, [m.WfmRcv(QUAD, DECIM)]),
                                  chunk_size=self.CHUNK, **cpu(pkg))

    @pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                               ("torch", "jax")])
    def test_resume(self, tmp_path, writer, reader):
        iq = tone_iq(4 * self.CHUNK, seed=4)
        half = 2 * self.CHUNK
        full = self._ex(writer)
        full_y = full.run(jnp.asarray(iq) if writer == "jax" else iq)
        full_y = np.asarray(full_y) if writer == "jax" else full_y.numpy()
        first = self._ex(writer)
        first.run(jnp.asarray(iq[:half]) if writer == "jax" else iq[:half])
        path = str(tmp_path / "wbfm.npz")
        first.save_checkpoint(path)
        second = self._ex(reader)
        second.load_checkpoint(path)
        tail = second.run(jnp.asarray(iq[half:]) if reader == "jax"
                          else iq[half:])
        tail = np.asarray(tail) if reader == "jax" else tail.numpy()
        assert rel(tail, full_y[half // DECIM:]) < 1e-5
