"""grtpu_torch.ops.fir / fft_filter held against grtpu on the CPU.

Same numpy inputs (local seeds) through grtpu's JAX function and the port.
Tolerance: max|port - grtpu| / max|grtpu| < 1e-5 for the float32 path
(grtpu's own FIR tests); the bf16x3 path < 1e-4; the FFT filter against
grtpu's FFT filter < 1e-5 (both are float32 FFTs of the same segments).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grtpu.ops import fir as jfir  # noqa: E402
from grtpu.ops.fft_filter import fft_filter as jfft  # noqa: E402
from grtpu_torch.ops import fir as tfir  # noqa: E402
from grtpu_torch.ops.fft_filter import fft_filter as tfft  # noqa: E402


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _x(rng, shape, complex_=False):
    x = rng.randn(*shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.randn(*shape)).astype(np.complex64)
    return x


@pytest.mark.parametrize("k", [1, 5, 16, 63, 256])
@pytest.mark.parametrize("n", [4, 100, 1000])
def test_fff(k, n):
    rng = np.random.RandomState(100 + k + n)
    x = _x(rng, (n + k - 1,))
    taps = rng.randn(k).astype(np.float32)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    got = tfir.fir_filter(torch.from_numpy(x), taps).numpy()
    assert got.dtype == np.float32
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("sig", ["ccf", "ccc", "fcc"])
@pytest.mark.parametrize("k", [7, 64])
def test_complex(sig, k):
    rng = np.random.RandomState(200 + k)
    n = 300
    x = _x(rng, (n + k - 1,), sig[0] == "c")
    taps = _x(rng, (k,), sig[2] == "c")
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    got = tfir.fir_filter(torch.from_numpy(x), taps).numpy()
    assert got.dtype == np.complex64
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("k,d", [(8, 2), (33, 4), (155, 8), (64, 3), (5, 7)])
def test_decim(k, d):
    rng = np.random.RandomState(300 + k * d)
    n = 64 * d
    x = _x(rng, (n + k - 1,))
    taps = rng.randn(k).astype(np.float32)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps), d))
    got = tfir.fir_filter(torch.from_numpy(x), taps, d).numpy()
    assert rel(got, ref) < 1e-5


def test_decim_complex():
    rng = np.random.RandomState(7)
    k, d, n = 40, 4, 400
    x = _x(rng, (n + k - 1,), True)
    taps = _x(rng, (k,), True)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps), d))
    got = tfir.fir_filter(torch.from_numpy(x), taps, d).numpy()
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("d", [1, 4])
def test_batch(d):
    rng = np.random.RandomState(8 + d)
    k, c, n = 31, 3, 256
    x = _x(rng, (c, n + k - 1))
    taps = rng.randn(k).astype(np.float32)
    ref = np.asarray(jfir.batch_fir_filter(jnp.asarray(x), jnp.asarray(taps), d))
    got = tfir.batch_fir_filter(torch.from_numpy(x), taps, d).numpy()
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("d", [1, 4])
def test_bf16x3_precision(d):
    """Per-call precision='bf16x3' equals grtpu's set_precision('bf16x3')."""
    rng = np.random.RandomState(11 + d)
    k, n = 129, 512
    x = _x(rng, (n + k - 1,))
    taps = (rng.randn(k) / k).astype(np.float32)
    jfir.set_precision("bf16x3")
    try:
        ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps), d))
    finally:
        jfir.set_precision("f32")
    got = tfir.fir_filter(torch.from_numpy(x), taps, d,
                          precision="bf16x3").numpy()
    assert rel(got, ref) < 1e-4


def test_bf16_precision_bound():
    """precision='bf16' (single pass) stays inside grtpu's bf16 bound."""
    rng = np.random.RandomState(13)
    k, n = 65, 512
    x = _x(rng, (n + k - 1,))
    taps = (rng.randn(k) / k).astype(np.float32)
    ref = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    got = tfir.fir_filter(torch.from_numpy(x), taps, precision="bf16").numpy()
    assert rel(got, ref) < 3e-2


def test_unknown_precision_raises():
    with pytest.raises(ValueError):
        tfir.fir_filter(torch.zeros(20), np.ones(5, np.float32),
                        precision="tf32")


def test_tensor_taps_equal_numpy_taps():
    rng = np.random.RandomState(14)
    x = torch.from_numpy(_x(rng, (300,)))
    taps = rng.randn(21).astype(np.float32)
    a = tfir.fir_filter(x, taps, 2)
    b = tfir.fir_filter(x, torch.from_numpy(taps), 2)
    assert torch.equal(a, b)


def test_compose_taps_identical():
    rng = np.random.RandomState(15)
    a = (rng.randn(31) * 0.2).astype(np.float32)
    b = (rng.randn(17) * 0.2).astype(np.float32)
    c = ((rng.randn(5) + 1j * rng.randn(5)) * 0.2).astype(np.complex64)
    np.testing.assert_array_equal(jfir.compose_taps(a, b), tfir.compose_taps(a, b))
    np.testing.assert_array_equal(jfir.compose_taps(c, a), tfir.compose_taps(c, a))
    np.testing.assert_array_equal(jfir.compose_taps_power(a, 4),
                                  tfir.compose_taps_power(a, 4))


@pytest.mark.parametrize("k", [9, 64, 200, 301])
def test_fft_filter(k):
    rng = np.random.RandomState(400 + k)
    n = 1000
    x = _x(rng, (n + k - 1,))
    taps = rng.randn(k).astype(np.float32)
    ref = np.asarray(jfft(jnp.asarray(x), jnp.asarray(taps)))
    got = tfft(torch.from_numpy(x), taps).numpy()
    assert got.dtype == np.float32
    assert rel(got, ref) < 1e-5


def test_fft_filter_ccc_decim():
    rng = np.random.RandomState(16)
    k, d, n = 55, 4, 600 * 4
    x = _x(rng, (n + k - 1,), True)
    taps = _x(rng, (k,), True)
    ref = np.asarray(jfft(jnp.asarray(x), jnp.asarray(taps), d))
    got = tfft(torch.from_numpy(x), taps, d).numpy()
    assert got.dtype == np.complex64
    assert rel(got, ref) < 1e-5


# ------------------------------------------- filterbank, tuner, rotate_taps
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("f,k,n", [(3, 8, 100), (9, 33, 1000), (2, 5, 4)])
def test_fir_filterbank(f, k, n, complex_):
    rng = np.random.RandomState(40 + f)
    x = _x(rng, (n + k - 1,), complex_)
    bank = rng.randn(f, k).astype(np.float32)
    ref = jfir.fir_filterbank(jnp.asarray(x), jnp.asarray(bank))
    got = tfir.fir_filterbank(torch.from_numpy(x), bank)
    assert got.shape == (f, n)
    assert rel(got.numpy(), ref) < 1e-5


def test_rotate_taps_identical():
    taps = np.random.RandomState(41).randn(73).astype(np.float32)
    np.testing.assert_array_equal(jfir.rotate_taps(taps, 400e3, 2.048e6),
                                  tfir.rotate_taps(taps, 400e3, 2.048e6))


@pytest.mark.parametrize("decim,n", [(1, 512), (8, 4096), (8, 32768)])
def test_freq_xlating_fir_filter(decim, n):
    """The tuner: the FIR to 1e-5, and the float32 rotator ramp rounded as
    grtpu's compiled step rounds it (grtpu runs under ``jax.jit``, as its
    executor runs it: XLA then fuses the ramp's multiply-add) — at 32,768
    samples the ramp reaches ~4e4 rad, where one float32 step is 4e-3 rad,
    so an order that rounds differently would show at 1e-3.  The carried
    phase agrees to 1e-6 rad."""
    rng = np.random.RandomState(42)
    taps = rng.randn(41).astype(np.float32) / 41
    rt = jfir.rotate_taps(taps, 400e3, 2.048e6)
    inc = -2 * np.pi * 400e3 / 2.048e6
    x = _x(rng, (n + 40,), True)
    ref, rph = jax.jit(lambda v, ph: jfir.freq_xlating_fir_filter(
        v, rt, ph, inc, decim))(jnp.asarray(x), jnp.float32(1.25))
    got, gph = tfir.freq_xlating_fir_filter(
        torch.from_numpy(x), rt, torch.tensor(1.25), inc, decim)
    assert got.dtype == torch.complex64 and got.shape == (n // decim,)
    assert rel(got.numpy(), ref) < 1e-5
    assert gph.dtype == torch.float32
    assert abs(float(gph) - float(rph)) < 1e-6


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_freq_xlating_precision_argument(precision):
    rng = np.random.RandomState(43)
    rt = tfir.rotate_taps(rng.randn(33).astype(np.float32) / 33, 1e3, 8e3)
    x = torch.from_numpy(_x(rng, (1024 + 32,), True))
    exact, _ = tfir.freq_xlating_fir_filter(x, rt, 0.0, -0.785, 4)
    got, _ = tfir.freq_xlating_fir_filter(x, rt, 0.0, -0.785, 4,
                                          precision=precision)
    assert rel(got.numpy(), exact.numpy()) < (1e-4 if precision == "bf16x3"
                                              else 3e-2)
