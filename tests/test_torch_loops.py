"""grtpu_torch's synchronization loops held against grtpu's on the CPU.

The same numpy inputs (local RandomState seeds) go through
``grtpu.digital.loops`` and ``grtpu_torch.digital.loops``.  Tolerances: the
MMSE bank is identical; Costas, exact and windowed M&M agree to atol 1e-5;
the chunked M&M to atol 1e-4 with identical decisions; differential codes
exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grtpu.digital import loops as jl  # noqa: E402
from grtpu.ops import dsp as jdsp  # noqa: E402
from grtpu.ops import mmse_interp as jmm  # noqa: E402
from grtpu_torch.digital import loops as tl  # noqa: E402
from grtpu_torch.ops import dsp as tdsp  # noqa: E402
from grtpu_torch.ops import mmse_interp as tmm  # noqa: E402

GO, GM = 0.25 * 0.175 ** 2, 0.175


def t(a):
    return torch.from_numpy(np.array(a))


def nrz(nsym, sps, complex_mode, seed, levels=(-1.0, 1.0), ppm=50.0):
    """Hanning-shaped symbols at sps samples/symbol, resampled with a small
    clock offset, plus a little noise."""
    rng = np.random.RandomState(seed)
    sym = rng.choice(levels, nsym)
    if complex_mode:
        sym = sym + 1j * rng.choice(levels, nsym)
    up = np.zeros(nsym * sps, np.complex128 if complex_mode else np.float64)
    up[::sps] = sym
    h = np.hanning(2 * sps - 1)
    sig = np.convolve(up, h / h.sum(), "same")
    tt = np.arange(0, len(sig) - 2, 1 + ppm * 1e-6)
    fr = tt % 1
    sig = (1 - fr) * sig[tt.astype(int)] + fr * sig[tt.astype(int) + 1]
    noise = 0.02 * rng.randn(len(sig))
    if complex_mode:
        noise = noise + 0.02j * rng.randn(len(sig))
    return (sig + noise).astype(np.complex64 if complex_mode else np.float32)


def fsk4_decide(v):
    v = np.asarray(v)
    return np.where(v > 2 / 3, 1, np.where(v > 0, 0, np.where(v > -2 / 3, 2, 3)))


def test_mmse_table_identical():
    np.testing.assert_array_equal(tmm.mmse_taps(), jmm.mmse_taps())
    assert tmm.mmse_taps().dtype == np.float32


def test_mmse_interpolate():
    rng = np.random.RandomState(1)
    x = rng.randn(200).astype(np.float32)
    pos = np.sort(rng.uniform(0, 190, 64)).astype(np.float32)
    ref = np.asarray(jmm.mmse_interpolate(jnp.asarray(x), jnp.asarray(pos)))
    got = tmm.mmse_interpolate(t(x), t(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    bank = tmm.bank_on("cpu")
    p = tmm.interpolate_point(t(x[10:18]), torch.tensor(0.3), bank).item()
    q = float(jmm.interpolate_point(jnp.asarray(x[10:18]), 0.3,
                                    jnp.asarray(jmm.mmse_taps())))
    assert abs(p - q) < 1e-5


def test_control_loop_helpers():
    assert tdsp.control_loop_gains(0.062) == jdsp.control_loop_gains(0.062)
    ph = np.linspace(-20, 20, 101).astype(np.float32)
    np.testing.assert_allclose(tdsp.phase_wrap(t(ph)).numpy(),
                               np.asarray(jdsp.phase_wrap(jnp.asarray(ph))),
                               atol=1e-5)


def wrap(a):
    return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi


@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_loop(order):
    rng = np.random.RandomState(order)
    m = order
    pts = np.exp(1j * (np.pi / m + 2 * np.pi * rng.randint(0, m, 300) / m))
    x = (pts * np.exp(1j * (0.4 + 0.01 * np.arange(300)))
         + 0.05 * (rng.randn(300) + 1j * rng.randn(300))).astype(np.complex64)
    yj, (pj, fj) = jl.costas_loop(jnp.asarray(x), jl.costas_init_state(),
                                  0.062, order)
    yt, (pt, ft) = tl.costas_loop(t(x), tl.costas_init_state("cpu"), 0.062, order)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    assert abs(wrap(pt.item() - float(pj))) < 1e-5
    assert abs(ft.item() - float(fj)) < 1e-5


@pytest.mark.parametrize("complex_mode", [False, True])
def test_mm_exact(complex_mode):
    x = nrz(600, 5, complex_mode, seed=3)
    fj = jl.clock_recovery_mm_cc if complex_mode else jl.clock_recovery_mm_ff
    ft = tl.clock_recovery_mm_cc if complex_mode else tl.clock_recovery_mm_ff
    yj, nj, sj = fj(jnp.asarray(x), jl.mm_init_state(5.0, 0.5, complex_mode),
                    5.0, GO, GM, 0.005)
    yt, nt, st = ft(t(x), tl.mm_init_state(5.0, 0.5, complex_mode, "cpu"), 5.0, GO,
                    GM, 0.005)
    n = int(nj)
    assert nt.dtype == torch.int32 and int(nt) == n > 550
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt[:n].numpy(), np.asarray(yj)[:n], atol=1e-5)
    assert float(st.base) == float(sj.base)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    rebased = tl.rebase_mm_state(st, 100)
    assert float(rebased.base) == float(sj.base) - 100


@pytest.mark.parametrize("complex_mode", [False, True])
def test_mm_windowed(complex_mode):
    W, sps = 32, 4
    x = nrz(400, sps, complex_mode, seed=5)
    xw = np.concatenate([np.zeros(W, x.dtype), x, np.zeros(2 * W, x.dtype)])
    fj = (jl.clock_recovery_mm_cc_windowed if complex_mode
          else jl.clock_recovery_mm_ff_windowed)
    ft = (tl.clock_recovery_mm_cc_windowed if complex_mode
          else tl.clock_recovery_mm_ff_windowed)
    yj, sj = fj(jnp.asarray(xw), jl.mm_windowed_init_state(
        sps, 0.5, complex_mode), sps, GO, GM, 0.005, W=W)
    yt, st = ft(t(xw), tl.mm_windowed_init_state(sps, 0.5, complex_mode, "cpu"), sps,
                GO, GM, 0.005, W=W)
    assert yt.shape == yj.shape and yt.shape[0] > 400
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("sps", [4, 5.3, 2.5])
def test_window_rows(sps):
    """Per-symbol rows on the floor grid of the rationalized clock."""
    W = 32
    xw = np.random.RandomState(6).randn(1000).astype(np.float32)
    rows_t, d_t, T_t, L_t = tl._window_rows(t(xw), sps, W, 8)
    rows_j, d_j, T_j, L_j = jl._window_rows(jnp.asarray(xw), sps, W, 8)
    assert (T_t, L_t) == (T_j, L_j)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def _chunked_input(x, sps, W, chunk, exact_multiple):
    """Windowed-layout input whose symbol count T = ((n - L) // sps) + 1 is
    (or is not) a multiple of ``chunk``."""
    L = sps + 2 * W + 8
    xw = np.concatenate([np.zeros(W, x.dtype), x, np.zeros(L, x.dtype)])
    for n in range(len(xw), 0, -1):
        T = (n - L) // sps + 1
        if (T % chunk == 0) == exact_multiple:
            return xw[:n], T
    raise AssertionError("no length found")


@pytest.mark.parametrize("complex_mode", [False, True])
def test_mm_chunked(complex_mode):
    """T % chunk != 0: grtpu's slices never overrun, the two agree."""
    sps, W, chunk = 5, 32, 16
    levels = (-1.0, 1.0) if complex_mode else (-1.0, -1 / 3, 1 / 3, 1.0)
    x = nrz(700, sps, complex_mode, seed=7, levels=levels)
    xw, T = _chunked_input(x, sps, W, chunk, exact_multiple=False)
    fj = (jl.clock_recovery_mm_cc_chunked if complex_mode
          else jl.clock_recovery_mm_ff_chunked)
    ft = (tl.clock_recovery_mm_cc_chunked if complex_mode
          else tl.clock_recovery_mm_ff_chunked)
    yj, sj = fj(jnp.asarray(xw), jl.mm_windowed_init_state(
        float(sps), 0.5, complex_mode), sps, GO, GM, 0.005, W=W, chunk=chunk)
    yt, st = ft(t(xw), tl.mm_windowed_init_state(float(sps), 0.5,
                                                 complex_mode, "cpu"),
                sps, GO, GM, 0.005, W=W, chunk=chunk)
    assert yt.shape == yj.shape == ((T // chunk) * chunk,)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)
    if complex_mode:
        for part in (np.real, np.imag):
            np.testing.assert_array_equal(np.sign(part(yt.numpy())),
                                          np.sign(part(np.asarray(yj))))
    else:
        np.testing.assert_array_equal(fsk4_decide(yt.numpy()),
                                      fsk4_decide(np.asarray(yj)))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_mm_chunked_exact_multiple_against_windowed():
    """T % chunk == 0: grtpu's last chunk reads a clamped (shifted) span;
    the port pads instead, so its chunked 4FSK decisions must match its own
    windowed decisions on a clean stream through the last chunk."""
    sps, W, chunk = 5, 32, 16
    x = nrz(700, sps, False, seed=9, levels=(-1.0, -1 / 3, 1 / 3, 1.0))
    xw, T = _chunked_input(x, sps, W, chunk, exact_multiple=True)
    st0 = tl.mm_windowed_init_state(float(sps), 0.5, device="cpu")
    yc, _ = tl.clock_recovery_mm_ff_chunked(t(xw), st0, sps, GO, GM, 0.005,
                                            W=W, chunk=chunk)
    yw, _ = tl.clock_recovery_mm_ff_windowed(t(xw), st0, sps, GO, GM, 0.005,
                                             W=W)
    assert yc.shape == (T,) and yw.shape[0] >= T
    settle = 100
    dc = fsk4_decide(yc.numpy())[settle:]
    dw = fsk4_decide(yw[:T].numpy())[settle:]
    np.testing.assert_array_equal(dc, dw)
    last = slice(T - chunk - settle, T - settle)
    np.testing.assert_array_equal(dc[last], dw[last])


def test_diff_codes_identical():
    rng = np.random.RandomState(11)
    for m in (2, 4, 8):
        x = rng.randint(0, m, 257).astype(np.uint8)
        s = np.uint8(rng.randint(0, m))
        for fj, ft in ((jl.diff_encode, tl.diff_encode),
                       (jl.diff_decode, tl.diff_decode)):
            yj, sj = fj(jnp.asarray(x), jnp.asarray(s), m)
            yt, st = ft(t(x), torch.tensor(s), m)
            assert yt.dtype == torch.uint8
            np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
            assert st.item() == int(sj)
    z = (rng.randn(64) + 1j * rng.randn(64)).astype(np.complex64)
    s = np.complex64(0.3 - 0.2j)
    yj, sj = jl.diff_phasor(jnp.asarray(z), jnp.asarray(s))
    yt, st = tl.diff_phasor(t(z), torch.tensor(s))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
    assert st.item() == complex(sj)
    x = rng.randn(50).astype(np.float32)
    np.testing.assert_array_equal(tl.binary_slicer(t(x)).numpy(),
                                  np.asarray(jl.binary_slicer(jnp.asarray(x))))


def test_cumsum_matches_xla_order():
    rng = np.random.RandomState(12)
    for n in (1, 7, 16, 17, 64, 100, 300):
        x = (rng.randn(n) * 10).astype(np.float32)
        np.testing.assert_array_equal(tl._cumsum(t(x)).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x))))
