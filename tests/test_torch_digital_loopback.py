"""BASELINE config #3's receive loops and modem in grtpu_torch, held against
grtpu on the CPU.

The same numpy inputs (local seeds) go through ``grtpu.digital`` and
``grtpu_torch.digital``: the FLL, AGC2 and constellation-receiver loops
(exact and chunked), ``GenericModem`` (clean, CFO + noise, fractional sps,
chunked, each stage through ``upto``), the digital blocks, the
``GenericDemodBlock`` / GMSK hier graphs, and the vmapped chunked bank.

Tolerances: decisions identical; AGC, constellation receiver and modulator
samples to atol 1e-5.  The FLL's samples are held to atol 5e-5: grtpu's
``exp(-1j * phase)`` calls glibc's sinf/cosf (XLA's complex exp), which no
torch op reproduces bit for bit, and the loop's phase, a free integrator,
adds up those last-bit differences over the run (1.1e-5 to 1.4e-5 after
2048-4096 samples); its frequency agrees to 1e-6.  Where a stage consumes
an FLL output whose last bits differ (the chunked clock sync rounds its
input to bfloat16), the stage is held on grtpu's own input instead, and the
chain at its decisions.  Two reference faults are held against numpy
goldens: ``agc2_chunked``'s floored cumprod and the chunked loops' rails.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
from grtpu.blocks import analog as janalog  # noqa: E402
from grtpu.digital import blocks as jdb  # noqa: E402
from grtpu.digital import constellation as jcon  # noqa: E402
from grtpu.digital import generic_mod_demod as jgm  # noqa: E402
from grtpu.digital import loops as jl  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu_torch.blocks import analog as tanalog  # noqa: E402
from grtpu_torch.blocks import pfb as tpfb  # noqa: E402
from grtpu_torch.digital import blocks as tdb  # noqa: E402
from grtpu_torch.digital import constellation as tcon  # noqa: E402
from grtpu_torch.digital import generic_mod_demod as tgm  # noqa: E402
from grtpu_torch.digital import loops as tl  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

FLL_TOL = 5e-5


def t(a):
    return torch.from_numpy(np.array(a))


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def wrap(a):
    return (np.asarray(a) + np.pi) % (2 * np.pi) - np.pi


def qpsk_samples(n, sps, seed, cfo=0.01, noise=0.05):
    rng = np.random.RandomState(seed)
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.randint(0, 4, n // sps)))
    x = np.repeat(sym, sps) * np.exp(1j * cfo * np.arange(n))
    x = x + noise * (rng.randn(n) + 1j * rng.randn(n))
    return x.astype(np.complex64)


def best_ber(sent, got, max_shift=64, settle=0):
    """BER minimized over the alignment shift (tests/test_digital.py)."""
    best = 1.0
    for s in range(max_shift):
        n = min(len(got) - s, len(sent)) - 32
        if n <= settle:
            continue
        best = min(best, float((got[s + settle: s + n]
                                != sent[settle:n]).mean()))
    return best


# ------------------------------------------------------------------- FLL
def test_band_edge_taps_identical():
    for sps, ro, k in ((4.0, 0.35, 16), (2.0, 0.35, 8), (5.3, 0.5, 21)):
        for a, b in zip(tl.band_edge_taps(sps, ro, k),
                        jl.band_edge_taps(sps, ro, k)):
            np.testing.assert_array_equal(a, b)


def test_fll_band_edge_exact():
    K = 16
    xh = np.concatenate([np.zeros(K - 1, np.complex64),
                         qpsk_samples(2048, 4, seed=1)])
    yj, (pj, fj) = jl.fll_band_edge(jnp.asarray(xh), jl.fll_init_state(), 4.0,
                                    0.35, K, 0.035)
    yt, (pt, ft) = tl.fll_band_edge(t(xh), tl.fll_init_state("cpu"), 4.0,
                                    0.35, K, 0.035)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=FLL_TOL)
    assert abs(ft.item() - float(fj)) < 1e-6
    assert abs(wrap(pt.item() - float(pj))) < FLL_TOL


@pytest.mark.parametrize("chunk", [32, 64])
def test_fll_band_edge_chunked(chunk):
    K = 8
    xh = np.concatenate([np.zeros(K - 1, np.complex64),
                         qpsk_samples(2048, 2, seed=2, cfo=0.004)])
    yj, (pj, fj) = jl.fll_band_edge_chunked(
        jnp.asarray(xh), jl.fll_init_state(), 2.0, 0.35, K, 0.035,
        chunk=chunk)
    yt, (pt, ft) = tl.fll_band_edge_chunked(
        t(xh), tl.fll_init_state("cpu"), 2.0, 0.35, K, 0.035, chunk=chunk)
    assert yt.shape == yj.shape and yt.dtype == torch.complex64
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=FLL_TOL)
    assert abs(ft.item() - float(fj)) < 1e-6
    assert abs(wrap(pt.item() - float(pj))) < FLL_TOL
    with pytest.raises(ValueError):
        tl.fll_band_edge_chunked(t(xh[:-1]), tl.fll_init_state("cpu"), 2.0,
                                 0.35, K, 0.035, chunk=chunk)


def _fll_golden(x, sps, rolloff, K, gains):
    """numpy float64 FLL with the exact scan's rule: the frequency clipped
    to +-2pi/sps on every step (digital_fll_band_edge_cc.cc)."""
    alpha, beta = gains
    up, lo = (v.astype(np.complex128) for v in
              jl.band_edge_taps(sps, rolloff, K))
    fmax = 2 * np.pi / sps
    phase = freq = 0.0
    karr = np.arange(K) - (K - 1)
    freqs = []
    for i in range(len(x) - (K - 1)):
        rwin = x[i:i + K] * np.exp(-1j * (phase + freq * karr))
        err = np.clip(abs((rwin * up).sum()) ** 2
                      - abs((rwin * lo).sum()) ** 2, -1.0, 1.0)
        freq = np.clip(freq + beta * err, -fmax, fmax)
        phase = wrap(phase + freq + alpha * err)
        freqs.append(freq)
    return np.asarray(freqs)


def test_fll_rails_against_golden():
    """Rail semantics (a reference fault, reproduced): the exact FLL clips
    its frequency on every step, as the numpy golden does; the chunked FLL
    clips the cumulative sum (grtpu's loops.py:319), so a loop driven into
    the rail leaves it differently.  The port's chunked form is held to
    grtpu's, its exact form to the golden."""
    K, sps, gains = 8, 2.0, (0.0, 1.0)
    rng = np.random.RandomState(4)
    n = 256
    x = (np.exp(1j * 1.2 * np.arange(n)) + 0.3 * (rng.randn(n) + 1j *
                                                   rng.randn(n)))
    xh = np.concatenate([np.zeros(K - 1), x]).astype(np.complex64)
    golden = _fll_golden(xh.astype(np.complex128), sps, 0.35, K, gains)
    fmax = 2 * np.pi / sps
    assert np.abs(golden).max() < fmax            # per-step: off the rail
    _, (_, f_exact) = tl.fll_band_edge(t(xh), tl.fll_init_state("cpu"), sps,
                                       0.35, K, 0.0, gains=gains)
    assert abs(f_exact.item() - golden[-1]) < 1e-4
    yj, (_, fj) = jl.fll_band_edge_chunked(
        jnp.asarray(xh), jl.fll_init_state(), sps, 0.35, K, 0.0, gains=gains,
        chunk=64)
    yt, (_, ft) = tl.fll_band_edge_chunked(
        t(xh), tl.fll_init_state("cpu"), sps, 0.35, K, 0.0, gains=gains,
        chunk=64)
    assert abs(ft.item() - float(fj)) < 1e-5
    assert abs(abs(ft.item()) - fmax) < 1e-6      # cumulative: held at it
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)


# ------------------------------------------------------------------ AGC2
def _agc2_golden(x, g0, att, dec, ref, clamp):
    """numpy float64 per-sample AGC2 with grtpu's rate rule; ``clamp``
    adds gr_agc2's floor (a gain below 0 becomes 1e-4)."""
    g, ys = g0, []
    for v in x:
        y = v * g
        err = ref - abs(y)
        g = g + (att if err < 0 else dec) * err
        if clamp and g < 0:
            g = 1e-4
        ys.append(y)
    return np.asarray(ys), g


@pytest.mark.parametrize("chunk", [16, 64])
def test_agc2_chunked(chunk):
    x = (3.0 * qpsk_samples(1024, 4, seed=3)).astype(np.complex64)
    yj, gj = jl.agc2_chunked(jnp.asarray(x), 0.25, 0.1, 0.01, 1.0, chunk=chunk)
    yt, gt = tl.agc2_chunked(t(x), 0.25, 0.1, 0.01, 1.0, chunk=chunk)
    assert yt.dtype == torch.complex64
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    assert abs(gt.item() - float(gj)) < 1e-6
    # the chunked closed form tracks the per-sample recurrence
    want, g = _agc2_golden(x.astype(np.complex128), 0.25, 0.1, 0.01, 1.0,
                           clamp=True)
    np.testing.assert_allclose(yt.numpy(), want, atol=2e-2)
    assert abs(gt.item() - g) < 5e-3


def test_agc2_chunked_fault_against_golden():
    """Where r|x| > 1 the cumprod turns negative and grtpu floors it at
    1e-30 (loops.py:338): the chunked gain leaves gr_agc2's per-sample
    recurrence, which the golden runs with gr_agc2's clamp.  The port
    reproduces grtpu there (parity).  The per-sample Agc2 block follows the
    same recurrence without gr_agc2's clamp (grtpu's rule)."""
    x = np.full(64, 15.0 + 0j, np.complex64)       # |x| > 1 / attack
    yj, gj = jl.agc2_chunked(jnp.asarray(x), 0.5, 0.1, 0.01, 1.0, chunk=64)
    yt, gt = tl.agc2_chunked(t(x), 0.5, 0.1, 0.01, 1.0, chunk=64)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    want, g = _agc2_golden(x.astype(np.complex128), 0.5, 0.1, 0.01, 1.0,
                           clamp=True)
    assert np.isfinite(want).all() and g > 0
    assert np.abs(yt.numpy() - want).max() > 1.0      # the fault shows
    unclamped, _ = _agc2_golden(x.astype(np.complex128), 0.5, 0.1, 0.01,
                                1.0, clamp=False)
    _, y_blk = tanalog.Agc2(0.1, 0.01, 1.0, 0.5).apply(torch.tensor(0.5), t(x))
    np.testing.assert_allclose(y_blk.numpy(), unclamped, rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------- constellation receiver
@pytest.mark.parametrize("m", [2, 4, 8])
def test_constellation_receiver(m):
    rng = np.random.RandomState(m)
    pts = jcon.psk_constellation(m)
    sym = rng.randint(0, m, 600)
    x = (pts.points[sym] * np.exp(1j * (0.3 + 0.02 * np.arange(600)))
         + 0.05 * (rng.randn(600) + 1j * rng.randn(600))).astype(np.complex64)
    sj, yj, (pj, fj) = jl.constellation_receiver(
        jnp.asarray(x), jl.costas_init_state(), pts, 0.06)
    st, yt, (pt, ft) = tl.constellation_receiver(
        t(x), tl.costas_init_state("cpu"), tcon.psk_constellation(m), 0.06)
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    assert abs(wrap(pt.item() - float(pj))) < 1e-5
    assert abs(ft.item() - float(fj)) < 1e-6


@pytest.mark.parametrize("chunk,refine", [(8, 2), (8, 1), (4, 2)])
def test_constellation_receiver_chunked(chunk, refine):
    """At the chunks grtpu's modem uses (it runs 8; from 16 up the loop
    slips in both packages, generic_mod_demod.py:196-198)."""
    rng = np.random.RandomState(5)
    c = jcon.psk_constellation(4)
    c.points = (c.points * np.exp(1j * np.pi / 4)).astype(np.complex64)
    tc = tcon.Constellation(c.points)
    x = (c.points[rng.randint(0, 4, 512)]
         * np.exp(1j * (0.2 + 0.005 * np.arange(512)))
         + 0.05 * (rng.randn(512) + 1j * rng.randn(512))).astype(np.complex64)
    sj, yj, (pj, fj) = jl.constellation_receiver_chunked(
        jnp.asarray(x), jl.costas_init_state(), c, 0.06, chunk=chunk,
        refine=refine)
    st, yt, (pt, ft) = tl.constellation_receiver_chunked(
        t(x), tl.costas_init_state("cpu"), tc, 0.06, chunk=chunk,
        refine=refine)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    assert abs(wrap(pt.item() - float(pj))) < 1e-5
    assert abs(ft.item() - float(fj)) < 1e-6


def test_constellation_receiver_tie_takes_the_first_point():
    """y = 1j lies at distance^2 2 from both BPSK points: both packages
    take the first index, as jnp.argmin and torch.argmin do."""
    x = np.array([1j, 1j, -1.0, 1.0], np.complex64)
    sj, _, _ = jl.constellation_receiver(jnp.asarray(x), jl.costas_init_state(),
                                         jcon.psk_constellation(2), 0.06)
    st, _, _ = tl.constellation_receiver(t(x), tl.costas_init_state("cpu"),
                                         tcon.psk_constellation(2), 0.06)
    assert int(st[0]) == int(np.asarray(sj)[0]) == 0
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_mm_window_rows_legacy():
    x = np.arange(300, dtype=np.float32)
    rj, Tj, Lj = jl._mm_window_rows(jnp.asarray(x), 4, 16)
    rt, Tt, Lt = tl._mm_window_rows(t(x), 4, 16)
    assert (Tt, Lt) == (Tj, Lj)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


# ------------------------------------------------------------ GenericModem
def modems(**kw):
    return jgm.GenericModem(**kw), tgm.GenericModem(device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(m=4, samples_per_symbol=4),
                                dict(m=2, samples_per_symbol=2),
                                dict(m=8, samples_per_symbol=4,
                                     differential=False),
                                dict(m=4, samples_per_symbol=2.5)],
                         ids=["qpsk4", "bpsk2", "8psk", "frac2.5"])
def test_generic_modulate(kw):
    jm, tm = modems(**kw)
    bits = np.random.RandomState(6).randint(0, 2, 600).astype(np.uint8)
    yj, yt = np.asarray(jm.modulate(bits)), tm.modulate(bits)
    assert yt.device.type == "cpu" and yt.dtype == torch.complex64
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5)


@pytest.mark.parametrize("sps", [4, 2.5], ids=["int", "frac"])
def test_generic_exact_chain(sps):
    """The exact chain (tests/test_digital.py:376-421's scenarios at a
    shorter length): CFO + noise at integer sps, clean at fractional sps.
    Bits and FLL frequency equal grtpu's; BER under the reference's gate."""
    jm, tm = modems(m=4, samples_per_symbol=sps)
    bits = np.random.RandomState(7).randint(0, 2, 1200).astype(np.uint8)
    x = np.asarray(jm.modulate(bits))
    if sps == 4:
        x = x * np.exp(1j * 0.004 * np.arange(len(x)))
        x = x + 0.05 * (np.random.RandomState(8).randn(len(x))
                        + 1j * np.random.RandomState(9).randn(len(x)))
    x = x.astype(np.complex64)
    bj, dj = jm.demodulate_diag(x)
    bt, dt = tm.demodulate_diag(x)
    np.testing.assert_array_equal(bt, bj)
    assert set(dt) == set(dj)
    assert abs(dt["freq"] - dj["freq"]) < 1e-6
    assert abs(dt["clock_rate"] - dj["clock_rate"]) < 1e-4
    assert dt["symbols"].shape == dj["symbols"].shape
    assert best_ber(bits, bt, settle=300) < 0.02


def test_generic_chunked_chain_and_stages():
    """chunked=True (tests/test_digital.py:423-446): bits equal grtpu's on a
    noisy CFO burst; each stage through ``upto`` on grtpu's own input."""
    jm, tm = modems(m=4, samples_per_symbol=2, chunked=True)
    rng = np.random.RandomState(10)
    bits = rng.randint(0, 2, 3000).astype(np.uint8)
    x = np.asarray(jm.modulate(bits)) * np.exp(1j * 0.004 * np.arange(3000))
    x = (x + 0.08 * (rng.randn(3000) + 1j * rng.randn(3000))).astype(
        np.complex64)
    bj, bt = jm.demodulate(x), tm.demodulate(x)
    np.testing.assert_array_equal(bt, bj)
    assert best_ber(bits, bt, settle=600) < 0.02

    def jstage(upto):
        re, im = jm._demod_dev(jnp.asarray(x), upto=upto)
        return (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64)

    xa = jstage("agc")
    np.testing.assert_allclose(tm._demod_dev(t(x), upto="agc").numpy(), xa,
                               atol=1e-5)
    xf = jstage("fll")
    np.testing.assert_allclose(tm._demod_dev(t(x), upto="fll").numpy(), xf,
                               atol=FLL_TOL)
    # the clock stage on grtpu's FLL output (it rounds its input to bf16)
    clock = jstage("clock")
    W, kp = 32, -(-len(tm.mf_bank) // tm.nfilts)
    L = 2 + 2 * W + kp
    xw = np.concatenate([np.zeros(W, np.complex64), xf,
                         np.zeros(L + 2, np.complex64)])
    ys, _ = tpfb.pfb_clock_sync_chunked(
        t(xw), tpfb.pfb_clock_sync_windowed_init(32, "cpu"), 2, tm.mf_bank,
        32, tm.timing_bw, W=W, chunk=64)
    np.testing.assert_allclose(ys[: len(clock)].numpy(), clock, atol=1e-4)


def test_vmapped_bank_equals_a_loop_of_channels():
    """psk_bench's bank form at a small size: torch.func.vmap over the
    chunked _demod_dev gives, for every channel, exactly what one call on
    that channel gives."""
    from functools import partial

    tm = tgm.GenericModem(m=4, samples_per_symbol=2, chunked=True,
                          device="cpu")
    rng = np.random.RandomState(11)
    n = 2048
    xs = []
    for c in range(3):
        x = tm.modulate(rng.randint(0, 2, n).astype(np.uint8)).numpy()[:n]
        xs.append(x * np.exp(1j * (c - 1) * 2e-5 * np.arange(n)))
    X = t(np.stack(xs).astype(np.complex64))
    bank = torch.func.vmap(partial(tm._demod_dev, upto="all"))(X)
    for c in range(3):
        one = tm._demod_dev(X[c])
        for b, o in zip(bank, one):
            assert torch.equal(b[c], o)
    for upto in ("agc", "fll", "clock"):
        stage = torch.func.vmap(partial(tm._demod_dev, upto=upto))(X)
        assert torch.equal(stage[1], tm._demod_dev(X[1], upto=upto))


# ------------------------------------------------------------------ blocks
def _run_block(kind, blk, x, chunk, out_dtype):
    pkg = grtpu if kind == "jax" else grtpu_torch
    g = pkg.Graph()
    pin = g.add_input(blk.in_ports[0])
    pout = g.add_output(pkg.Port(out_dtype))
    g.connect(pin, blk, pout)
    kw = {"device": "cpu"} if kind == "torch" else {}
    return out(pkg.StreamExecutor(g, chunk_size=chunk, **kw).run(x))


def test_fll_band_edge_block():
    x = qpsk_samples(1024, 4, seed=12)
    yj = _run_block("jax", jdb.FllBandEdge(4, 0.35, 16, 0.035), x, 256,
                    jnp.complex64)
    yt = _run_block("torch", tdb.FllBandEdge(4, 0.35, 16, 0.035), x, 256,
                    torch.complex64)
    np.testing.assert_allclose(yt, yj, atol=FLL_TOL)


def test_constellation_receiver_block():
    c = jcon.psk_constellation(4)
    x = qpsk_samples(512, 1, seed=13, cfo=0.005)
    yj = _run_block("jax", jdb.ConstellationReceiver(c, 0.06), x, 128,
                    jnp.uint8)
    yt = _run_block("torch", tdb.ConstellationReceiver(
        tcon.psk_constellation(4), 0.06), x, 128, torch.uint8)
    np.testing.assert_array_equal(yt, yj)


def test_bytes_to_syms_block():
    x = np.random.RandomState(14).randint(0, 256, 64).astype(np.uint8)
    yj = _run_block("jax", jdb.BytesToSyms(), x, 16, jnp.float32)
    yt = _run_block("torch", tdb.BytesToSyms(), x, 16, torch.float32)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(yt, np.unpackbits(x) * 2.0 - 1.0)


def test_mpsk_receiver_block():
    x = qpsk_samples(512, 4, seed=15, cfo=0.003, noise=0.02)
    yj = _run_block("jax", jdb.MpskReceiver(4, 4), x, 128, jnp.complex64)
    yt = _run_block("torch", tdb.MpskReceiver(4, 4), x, 128, torch.complex64)
    assert yt.shape == yj.shape == (128,)
    np.testing.assert_allclose(yt, yj, atol=1e-5)


# ------------------------------------------------------------- hier graphs
def _qpsk_burst(nsym, sps, seed, snr_db=30.0, ebw=0.35):
    """RRC-shaped QPSK + AWGN (tests/test_vr_graph.py's _qpsk_burst)."""
    rng = np.random.default_rng(seed)
    pts = (np.asarray(jcon.psk_constellation(4).points)
           * np.exp(1j * np.pi / 4))
    up = np.zeros(nsym * sps, np.complex64)
    up[::sps] = pts[rng.integers(0, 4, nsym)]
    rrc = firdes.root_raised_cosine(sps, sps, 1.0, ebw, 11 * sps)
    x = np.convolve(up, rrc).astype(np.complex64)[: nsym * sps]
    sigma = np.sqrt((np.abs(x) ** 2).mean() / 10 ** (snr_db / 10) / 2)
    return (x + sigma * (rng.standard_normal(len(x)) + 1j *
                         rng.standard_normal(len(x)))).astype(np.complex64)


def test_generic_demod_graph_equals_hand_composition():
    """tests/test_vr_graph.py:159-205: the 4-block receive chain through the
    variable-rate executor at chunk 1000 equals the same stage functions
    composed by hand over the whole burst, and grtpu's graph decisions."""
    sps, ebw, nfilts = 4, 0.35, 32
    x = _qpsk_burst(1200, sps, seed=11)
    mf_bank = firdes.root_raised_cosine(nfilts, nfilts * sps, 1.0, ebw,
                                        11 * sps * nfilts)
    const = tcon.Constellation(np.asarray(jcon.psk_constellation(4).points)
                               * np.exp(1j * np.pi / 4))

    def build(kind):
        pkg, db, an = ((grtpu, jdb, janalog) if kind == "jax"
                       else (grtpu_torch, tdb, tanalog))
        pb = __import__(f"{pkg.__name__}.blocks.pfb", fromlist=["pfb"])
        c = (jcon.Constellation(const.points) if kind == "jax" else const)
        blocks = (an.Agc2(1e-1, 1e-2, 1.0, 1.0 / sps),
                  db.FllBandEdge(sps, ebw, sps * 4, 0.035),
                  pb.PfbClockSync(sps, 0.045, mf_bank, nfilts=nfilts),
                  db.ConstellationReceiver(c, 0.06))
        g = pkg.Graph()
        u8 = jnp.uint8 if kind == "jax" else torch.uint8
        c64 = jnp.complex64 if kind == "jax" else torch.complex64
        g.connect(g.add_input(pkg.Port(c64)), *blocks,
                  g.add_output(pkg.Port(u8)))
        return g, blocks

    g, (agc, fll, clk, rx) = build("torch")
    got = out(grtpu_torch.StreamExecutor(g, chunk_size=1000,
                                         device="cpu").run(x))
    _, xa = agc.apply(agc.init_state(), t(x))
    xf, _ = tl.fll_band_edge(torch.cat([xa.new_zeros(15), xa]),
                             tl.fll_init_state("cpu"), float(sps), ebw, 16,
                             0.035)
    ys, nv, _ = tpfb.pfb_clock_sync(
        torch.cat([xf.new_zeros(clk.history - 1), xf]),
        tpfb.pfb_clock_sync_init(nfilts, "cpu"), float(sps), mf_bank, nfilts,
        0.045)
    want, _, _ = tl.constellation_receiver(ys[: int(nv)],
                                           tl.costas_init_state("cpu"),
                                           const, 0.06)
    assert len(got) >= 1000
    np.testing.assert_array_equal(got, want.numpy().astype(np.uint8)[:len(got)])
    gj, _ = build("jax")
    ref = out(grtpu.StreamExecutor(gj, chunk_size=1000).run(x))
    np.testing.assert_array_equal(got, ref)


def test_gmsk_loopback_graph():
    """tests/test_vr_graph.py:340-356: GmskModBlock -> GmskDemodBlock."""
    data = np.random.default_rng(21).integers(0, 256, 400).astype(np.uint8)

    def run(kind):
        pkg, gm = (grtpu, jgm) if kind == "jax" else (grtpu_torch, tgm)
        u8 = jnp.uint8 if kind == "jax" else torch.uint8
        g = pkg.Graph()
        g.connect(g.add_input(pkg.Port(u8)), gm.GmskModBlock(2),
                  gm.GmskDemodBlock(2), g.add_output(pkg.Port(u8)))
        kw = {"device": "cpu"} if kind == "torch" else {}
        return out(pkg.StreamExecutor(g, chunk_size=200, **kw).run(data))

    got = run("torch")
    np.testing.assert_array_equal(got, run("jax"))
    bits = np.unpackbits(data)
    best = max((got[200:2800] == bits[200 - lag:2800 - lag]).mean()
               for lag in range(12))
    assert best > 0.995, best


def test_generic_mod_block_equals_modem():
    """GenericModBlock through the executor emits what GenericModem's
    modulate emits for the same bits (both packages)."""
    data = np.random.RandomState(16).randint(0, 256, 64).astype(np.uint8)
    g = grtpu_torch.Graph()
    g.connect(g.add_input(grtpu_torch.Port(torch.uint8)),
              tgm.GenericModBlock(m=4, samples_per_symbol=4),
              g.add_output(grtpu_torch.Port(torch.complex64)))
    got = out(grtpu_torch.StreamExecutor(g, chunk_size=16,
                                         device="cpu").run(data))
    want = tgm.GenericModem(m=4, samples_per_symbol=4,
                            device="cpu").modulate(np.unpackbits(data))
    np.testing.assert_allclose(got, want.numpy()[: len(got)], atol=1e-5)
    gj = grtpu.Graph()
    gj.connect(gj.add_input(grtpu.runtime.block.Port(jnp.uint8)),
               jgm.GenericModBlock(m=4, samples_per_symbol=4),
               gj.add_output(grtpu.runtime.block.Port(jnp.complex64)))
    ref = out(grtpu.StreamExecutor(gj, chunk_size=16).run(data))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_new_modules_import_no_jax_and_no_grtpu():
    """The slice's modules load without JAX and without grtpu (the way
    test_torch_executor_modes.py checks the runtime)."""
    mods = ["grtpu_torch.digital." + m for m in
            ("generic_mod_demod", "lfsr", "bert", "equalizers", "cpm",
             "modulation_utils", "loops", "blocks")]
    mods += ["grtpu_torch.models.channel", "grtpu_torch.ops.noise"]
    code = ("import sys; " + "; ".join(f"import {m}" for m in mods)
            + "; print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'grtpu')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.stdout.strip() == "[]"
