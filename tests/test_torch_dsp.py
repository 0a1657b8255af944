"""grtpu_torch.ops.dsp held against grtpu.ops.dsp on the CPU.

Same numpy inputs (local seeds) through both.  Tolerances: the FIR-based
recurrences and IIR filters agree with grtpu to max|diff| / max|grtpu| <
1e-5 (grtpu's FIR tolerance); the log-depth scans (grtpu's
``lax.associative_scan`` against the port's Hillis-Steele steps) associate
the same products in different orders and get grtpu's own scan-vs-FIR
bound, atol 1e-5 (tests/test_fir.py:352-365); the discriminators agree to
float32 rounding of atan2 (1e-5 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grtpu.ops import dsp as jd  # noqa: E402
from grtpu_torch.ops import dsp as td  # noqa: E402


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def fm_iq(n, seed):
    """A frequency-modulated complex tone: phase steps well inside (-pi, pi)."""
    rng = np.random.RandomState(seed)
    phase = np.cumsum(0.9 * np.sin(np.arange(n) * 0.01) + 0.1 * rng.randn(n))
    amp = 1.0 + 0.1 * rng.rand(n)
    return (amp * np.exp(1j * phase)).astype(np.complex64)


@pytest.mark.parametrize("fast", [False, True])
def test_quadrature_demod(fast):
    x = fm_iq(1001, 1)
    ref = np.asarray(jd.quadrature_demod(jnp.asarray(x), 0.7, fast=fast))
    got = td.quadrature_demod(T(x), 0.7, fast=fast).numpy()
    assert got.dtype == np.float32 and got.shape == (1000,)
    assert rel(got, ref) < 1e-5


def test_fast_atan2_quadrants():
    rng = np.random.RandomState(2)
    y = rng.randn(4000).astype(np.float32)
    x = rng.randn(4000).astype(np.float32)
    y[:4], x[:4] = [0, 0, 1, -1], [0, -1, 0, 0]
    ref = np.asarray(jd.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    got = td.fast_atan2(T(y), T(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.abs(got - np.arctan2(y, x)).max() < 2e-5


def test_frequency_modulator():
    """Same phase integrator; float32 cumulative sums in different orders
    (torch's CPU cumsum accumulates in float64), so the bound is the float32
    phase rounding over the chunk: |phi| < 300 rad here -> ~3e-5 rad."""
    rng = np.random.RandomState(3)
    x = (0.5 * rng.randn(1024)).astype(np.float32)
    ref_y, ref_ph = jd.frequency_modulator(jnp.asarray(x), jnp.float32(1.0), 0.6)
    got_y, got_ph = td.frequency_modulator(T(x), 1.0, 0.6)
    assert got_y.dtype == torch.complex64
    assert np.abs(got_y.numpy() - np.asarray(ref_y)).max() < 2e-4
    assert abs(float(got_ph) - float(ref_ph)) < 2e-4


@pytest.mark.parametrize("n", [1, 2, 7, 400])
def test_linear_recurrence(n):
    rng = np.random.RandomState(4 + n)
    a = rng.uniform(-0.99, 0.99, n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    ref_y, ref_l = jd.linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                        jnp.float32(0.3))
    got_y, got_l = td.linear_recurrence(T(a), T(b), 0.3)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(float(got_l), float(ref_l), atol=1e-5)


@pytest.mark.parametrize("a", [0.728, 0.2, 0.0, 0.95, 0.995, -0.6])
def test_linear_recurrence_const(a):
    """FIR branch (fast poles) and scan branch (0.95, 0.995), batched."""
    r = np.random.RandomState(1)
    b = r.randn(3, 400).astype(np.float32)
    y0 = r.randn(3).astype(np.float32)
    ref_y, ref_l = jd.linear_recurrence_const(a, jnp.asarray(b), jnp.asarray(y0))
    got_y, got_l = td.linear_recurrence_const(a, T(b), T(y0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), atol=1e-5)


def test_linear_recurrence_const_state_continuity():
    r = np.random.RandomState(2)
    b = T(r.randn(600).astype(np.float32))
    y_all, _ = td.linear_recurrence_const(0.7, b, 0.0)
    y1, s = td.linear_recurrence_const(0.7, b[:300], 0.0)
    y2, _ = td.linear_recurrence_const(0.7, b[300:], s)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y_all.numpy(),
                               atol=1e-5)


def test_slow_pole_chunked():
    """n > 2^17 with a slow pole takes the chunked closed form in both."""
    r = np.random.RandomState(5)
    n = (1 << 17) + 3000
    b = r.randn(n).astype(np.float32) * 0.01
    ref_y, ref_l = jd.linear_recurrence_const(0.995, jnp.asarray(b),
                                              jnp.float32(0.5))
    got_y, got_l = td.linear_recurrence_const(0.995, T(b), 0.5)
    assert rel(got_y.numpy(), np.asarray(ref_y)) < 1e-4
    assert abs(float(got_l) - float(ref_l)) < 1e-4 * np.abs(ref_y).max()


def test_slow_pole_chunked_batched():
    r = np.random.RandomState(6)
    b = r.randn(2, 3000).astype(np.float32)
    y0 = np.array([0.5, -1.0], np.float32)
    ref_y, ref_l = jax.vmap(lambda bb, s: jd._slow_pole_chunked(
        0.99, bb, s, 64))(jnp.asarray(b), jnp.asarray(y0))
    got_y, got_l = td._slow_pole_chunked(0.99, T(b), T(y0), 64)
    assert rel(got_y.numpy(), np.asarray(ref_y)) < 1e-5
    assert rel(got_l.numpy(), np.asarray(ref_l)) < 1e-5


@pytest.mark.parametrize("alpha", [0.3, 0.001])
def test_single_pole_iir(alpha):
    r = np.random.RandomState(7)
    x = r.randn(500).astype(np.float32)
    ref_y, ref_s = jd.single_pole_iir(jnp.asarray(x), jnp.float32(0.2), alpha)
    got_y, got_s = td.single_pole_iir(T(x), 0.2, alpha)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(float(got_s), float(ref_s), atol=1e-5)


@pytest.mark.parametrize("ff,fb", [
    ([0.2, 0.1], [1.0, 0.6]),             # de-emphasis form: truncated FIR
    ([0.5], [1.0, 0.3]),                  # one feed-forward tap
    ([0.2, 0.1, 0.05], [1.0]),            # FIR only
    ([0.1, 0.1], [1.0, 1.02]),            # unstable pole: the scan
    ([0.3, 0.2], [1.0, 0.5, -0.2]),       # second-order feedback: the loop
])
def test_iir_filter_chunked(ff, fb):
    """Two chunks with carried state equal grtpu's two chunks."""
    r = np.random.RandomState(8)
    x = r.randn(2, 150).astype(np.float32)
    js = jd.iir_init_state(len(ff), len(fb))
    ts = td.iir_init_state(len(ff), len(fb))
    for c in range(2):
        ry, js = jd.iir_filter(jnp.asarray(x[c]), js, ff, fb)
        gy, ts = td.iir_filter(T(x[c]), ts, ff, fb)
        assert rel(gy.numpy(), np.asarray(ry)) < 1e-5
    for a, b in zip(ts, js):
        assert tuple(a.shape) == tuple(b.shape)
        if b.size:
            assert rel(a.numpy(), np.asarray(b)) < 1e-5


def test_iir_init_state_shapes():
    for nff, nfb in ((1, 1), (2, 2), (4, 3)):
        a = jd.iir_init_state(nff, nfb)
        b = td.iir_init_state(nff, nfb)
        assert [tuple(v.shape) for v in b] == [tuple(v.shape) for v in a]
        assert all(v.dtype == torch.float32 for v in b)


# ----------------------------------------- rotator, NCO, VCO, phase mod, DC
def wrapped(a, b):
    """|a - b| over the circle, radians."""
    d = np.remainder(np.float64(a) - np.float64(b) + np.pi, 2 * np.pi)
    return abs(float(d) - np.pi)


@pytest.mark.parametrize("n", [257, 16384])
def test_rotate(n):
    """The phases reduced mod 2 pi in float64 before the float32 cos / sin,
    held to the float64 rotation at 1e-5 and the carried phase (float64)
    to 1e-6 rad.  Where grtpu's float32 ramp is accurate (257 samples, to
    189 rad) the port also agrees with grtpu (under ``jax.jit``, as its
    executor runs it) to 1e-5; at 16,384 samples grtpu's ramp reaches 1.2e4
    rad, where a float32 step is 1e-3 rad, and grtpu is the one off."""
    x = fm_iq(n, 20)
    ref, rph = jax.jit(lambda v, ph: jd.rotate(v, ph, 0.7353))(
        jnp.asarray(x), jnp.float32(0.5))
    got, gph = td.rotate(T(x), torch.tensor(0.5), 0.7353)
    k = np.arange(n, dtype=np.float64)
    exact = x.astype(np.complex128) * np.exp(1j * (0.5 + 0.7353 * k))
    assert got.dtype == torch.complex64 and gph.dtype == torch.float64
    assert rel(got.numpy(), exact) < 1e-5
    assert wrapped(gph, 0.5 + 0.7353 * n) < 1e-6
    if n == 257:
        assert rel(got.numpy(), ref) < 1e-5
    else:
        assert rel(np.asarray(ref), exact) > 1e-4


@pytest.mark.parametrize("name", ["nco_sin", "nco_cos", "nco_exp"])
def test_nco(name):
    """8,192 samples of the NCO (to 2.5e3 rad, where a float32 step is 2.4e-4
    rad: grtpu's float32 ramp is off by more than the 1e-5 tolerance there)
    held to the float64 waveform to 1e-5 and the carried phase to 1e-6
    rad."""
    got, gph = getattr(td, name)(torch.tensor(2.0), -0.3111, 8192)
    ph = 2.0 - 0.3111 * np.arange(8192, dtype=np.float64)
    exact = {"nco_sin": np.sin, "nco_cos": np.cos,
             "nco_exp": lambda p: np.exp(1j * p)}[name](ph)
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5)
    assert wrapped(gph, 2.0 - 0.3111 * 8192) < 1e-6
    # a plain number as the phase needs a device: the card unless named
    got2, _ = getattr(td, name)(2.0, -0.3111, 8192, device="cpu")
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_vco():
    """The phase is a float32 prefix sum; the two packages associate it
    differently (torch sums in float64 on a CPU), so the bound is absolute
    and grows with the length: 2e-4 at 4096 samples of |dphi| < 0.5."""
    f = (0.5 * np.sin(np.arange(4096) * 0.01)).astype(np.float32)
    ref, rph = jd.vco(jnp.asarray(f), jnp.float32(0.25), 0.9)
    got, gph = td.vco(T(f), torch.tensor(0.25), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    d = abs(float(gph) - float(rph))
    assert min(d, 2 * np.pi - d) < 2e-4


def test_phase_modulator():
    x = np.random.RandomState(21).randn(2000).astype(np.float32)
    ref = jd.phase_modulator(jnp.asarray(x), 1.7)
    got = td.phase_modulator(T(x), 1.7)
    assert got.dtype == torch.complex64
    assert rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("length", [8, 33])
def test_dc_blocker(length):
    """A prefix-sum difference at grtpu's own test length (1,000 samples):
    absolute bound 1e-4 on unit-variance input plus a DC of 3."""
    rng = np.random.RandomState(22)
    x = (3.0 + rng.randn(2000)).astype(np.float32)
    nst = (length - 1) + (length - 1) // 2
    js, ts = jnp.zeros(nst, jnp.float32), torch.zeros(nst)
    outs = []
    for c in range(2):  # two chunks: the carried history too
        seg = x[c * 1000:(c + 1) * 1000]
        ry, js = jd.dc_blocker(jnp.asarray(seg), js, length)
        gy, ts = td.dc_blocker(T(seg), ts, length)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-4)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        outs.append(gy.numpy())
    assert abs(np.concatenate(outs)[200:].mean()) < 0.05
