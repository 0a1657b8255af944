"""Parity of grtpu_torch.models.{atsc,atsc_rf} with grtpu's on the CPU.

Transport (``models.atsc``): the randomizer, interleavers, RS and trellis
encoder are numpy copies, identical; the 12-phase trellis decode (the
batched Viterbi, ``viterbi_fwd``'s twin on a CPU tensor) gives grtpu's
dibits; the loopback gives grtpu's packets; a transmitter resumes from
grtpu's state.

RF (``models.atsc_rf``), with the bounds each comparison is held to:
  * PN sequences, field sync segments, the mux and ``vsb_modulate``:
    identical (numpy copies).
  * ``fpll``, ``fpll_chunked``: within ``FPLL_TOL`` absolute, output and
    carried state (XLA's complex sinf/cosf and float32 prefix sums against
    torch's).  At lengths that are not a multiple of the chunk the port
    carries its state from the last valid sample (grtpu's comes from the
    zero pad): held to a float64 numpy golden of the chunk recursion, per
    sample, streamed over two calls; one call's output still equals
    grtpu's (it is causal).
  * ``bit_timing_loop``: identical symbols, integrator, lock, symbol index
    and state (the loop's prefix sum and interpolation dot are summed in
    XLA's order, its multiply-adds fused as XLA fuses them); resumed from
    grtpu's state mid-stream, identical to grtpu's run.
  * ``fs_correlate``: identical (+-1 sums, exact).
  * the equalizers' training and filtering: taps and outputs within
    ``EQ_TOL`` (dot products summed in another order), slicer decisions
    identical; one full field each for the linear (``nlms``) and the
    decision-feedback (``lms2``) equalizer.
The full RF loopback is ``slow``, as grtpu's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtpu.models import atsc as ja, atsc_rf as jr
from grtpu_torch.models import atsc as ta, atsc_rf as tr

RATIO = 2.5
FS = 10.762238e6 * RATIO
IF_NORM = 0.26
FPLL_TOL = 1e-4
EQ_TOL = 1e-4
CPU = "cpu"


def t(a):
    return torch.from_numpy(np.array(a))


def packets(rng, n):
    pk = rng.randint(0, 256, (n, 188)).astype(np.uint8)
    pk[:, 0] = ja.MPEG_SYNC
    return pk


# ---------------------------------------------------------------- transport
def test_randomizer_and_interleavers_identical():
    r = np.random.RandomState(55)
    pk = packets(r, 400)
    wj, wt = ja.Randomizer().randomize_packets(pk), \
        ta.Randomizer().randomize_packets(pk)
    np.testing.assert_array_equal(wj, wt)
    np.testing.assert_array_equal(ta.Randomizer().derandomize_packets(wt), pk)
    ij, it = ja.ConvolutionalInterleaver(), ta.ConvolutionalInterleaver()
    dj, dt = ja.ConvolutionalDeinterleaver(), ta.ConvolutionalDeinterleaver()
    data = r.randint(0, 256, 9000).astype(np.uint8)
    for part in np.split(data, [1000, 4321]):
        a, b = ij.process(part), it.process(part)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(dj.process(a), dt.process(b))


def test_trellis_fsm_and_encoder_identical():
    fj, ft = ja.atsc_trellis_fsm(), ta.atsc_trellis_fsm()
    for attr in ("NS", "OS", "PS", "PI"):
        np.testing.assert_array_equal(getattr(fj, attr), getattr(ft, attr))
    dib = np.random.RandomState(1).randint(0, 4, 12 * 300)
    st = np.arange(12, dtype=np.int32) % 8
    for a, b in zip(ja.trellis_encode(dib, st), ta.trellis_encode(dib, st)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noise", [0.0, 0.7, 1.2])
def test_trellis_decode_identical(noise):
    r = np.random.RandomState(7)
    dib = r.randint(0, 4, 12 * 600).astype(np.int32)
    levels, _ = ta.trellis_encode(dib)
    x = (levels + noise * r.randn(len(levels))).astype(np.float32)
    got = ta.trellis_decode(x, CPU)
    np.testing.assert_array_equal(got, ja.trellis_decode(x))
    if noise < 1.0:
        assert (got != dib).mean() < 0.01


@pytest.mark.parametrize("burst", [False, True], ids=["noise", "burst"])
def test_transport_loopback_identical(burst):
    r = np.random.RandomState(8)
    pk = packets(r, 16)
    tx = ta.AtscTransmitter()
    stream = np.concatenate([tx.process(pk), tx.process(packets(r, 56))])
    stream = stream + r.randn(len(stream)) * 0.5
    if burst:
        stream[5000:5040] = 7.0
    got, bad = ta.AtscReceiver(CPU).process(stream)
    want, bad_j = ja.AtscReceiver().process(stream)
    assert bad == bad_j == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:16], pk)


def test_transmitter_resumes_from_grtpu_state():
    r = np.random.RandomState(9)
    first, second = packets(r, 20), packets(r, 30)
    tj = ja.AtscTransmitter()
    tj.process(first)
    tt_ = ta.AtscTransmitter()
    tt_.load_state(tj.trellis_states, tj.interleaver.lines,
                   tj.interleaver.ptr)
    # the randomizer restarts per call in both (its field reset)
    np.testing.assert_array_equal(tt_.process(second), tj.process(second))


# --------------------------------------------------------------- RF: numpy
def test_rf_numpy_pieces_identical():
    np.testing.assert_array_equal(jr.ATSC_PN511, tr.ATSC_PN511)
    np.testing.assert_array_equal(jr.ATSC_PN63, tr.ATSC_PN63)
    saved = np.arange(12, dtype=np.uint8)
    for f in (0, 1):
        np.testing.assert_array_equal(jr.field_sync_codes(f, saved),
                                      tr.field_sync_codes(f, saved))
        np.testing.assert_array_equal(jr.fs_training_levels(f),
                                      tr.fs_training_levels(f))
    data = np.random.RandomState(10).randint(0, 8, (320, 828)).astype(np.uint8)
    mj, mt = jr.AtscFieldSyncMux(), tr.AtscFieldSyncMux()
    for part in np.split(data, [100]):
        np.testing.assert_array_equal(mj(part), mt(part))
    base = np.random.RandomState(11).randn(5000)
    np.testing.assert_array_equal(jr.vsb_modulate(base, IF_NORM, RATIO),
                                  tr.vsb_modulate(base, IF_NORM, RATIO))


# ---------------------------------------------------------------- RF: FPLL
def pilot(n, seed=5):
    r = np.random.default_rng(seed)
    return (1.25 * np.cos(2 * np.pi * IF_NORM * 1.0001 * np.arange(n))
            + 2.0 * r.standard_normal(n)).astype(np.float32)


def jstate(st):
    return [np.asarray(v) for v in st]


def assert_state_close(got, want, tol=FPLL_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def fpll_chunked_j():
    """grtpu's fpll_chunked, compiled once for this module."""
    return jax.jit(lambda s, v: jr.fpll_chunked(s, v, FS))


def golden_chunked(state, x, chunk=256, sweeps=2):
    """numpy float64 golden of fpll_chunked's chunk recursion, evaluated
    sample by sample, a shorter last chunk unpadded: its state comes from
    its last sample."""
    a = float(np.float32(1 - np.exp(-1.0 / FS / 5e-6)))
    alpha, beta, lim = 1e-3, 1e-3 ** 2 / 4, np.pi / 2
    rate, ref = tr.FPLL_AGC_RATE, tr.FPLL_AGC_REFERENCE
    gain, phase, freq, fi0, fq0 = (float(v) for v in state)
    out = []
    for c in range(0, len(x), chunk):
        seg = np.asarray(x[c:c + chunk], np.float64)
        n = len(seg)
        g_before = np.empty(n)
        for k in range(n):
            g_before[k] = gain
            gain = gain * (1 - rate * abs(seg[k])) + rate * ref
        inp = seg * g_before
        pd = np.zeros(n)
        for _ in range(sweeps):
            freq_traj = freq + beta * np.cumsum(pd)
            dphi = freq_traj + alpha * pd
            ph = np.mod(phase + freq + np.concatenate(
                [[0.0], np.cumsum(dphi)[:-1]]), 2 * np.pi)
            i_s, q_s = inp * np.sin(ph), inp * np.cos(ph)
            fi, fq = np.empty(n), np.empty(n)
            pi, pq = fi0, fq0
            for k in range(n):
                pi = (1 - a) * pi + a * i_s[k]
                pq = (1 - a) * pq + a * q_s[k]
                fi[k], fq[k] = pi, pq
            pd = np.clip(np.arctan2(fq, fi), -lim, lim)
        phase = np.mod(ph[-1] + alpha * pd[-1], 2 * np.pi)
        freq, fi0, fq0 = freq_traj[-1], fi[-1], fq[-1]
        out.append(i_s)
    return (gain, phase, freq, fi0, fq0), np.concatenate(out)


def test_fpll_per_sample_identical_within_bound():
    x = pilot(1024)
    sj, yj = jr.fpll(jr.fpll_init_state(IF_NORM * FS * 1.0002, FS),
                     jnp.asarray(x), FS)
    st, yt = tr.fpll(tr.fpll_init_state(IF_NORM * FS * 1.0002, FS, CPU),
                     t(x), FS)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=FPLL_TOL)
    assert_state_close(st, jstate(sj))


def test_fpll_chunked_identical_at_whole_chunks(fpll_chunked_j):
    x = pilot(4096)
    s0j = jr.fpll_init_state(IF_NORM * FS * 1.0002, FS)
    sj, yj = fpll_chunked_j(s0j, jnp.asarray(x))
    st, yt = tr.fpll_chunked(
        tr.state_from_numpy(tr.FpllState, jstate(s0j), CPU), t(x), FS)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=FPLL_TOL)
    assert_state_close(st, jstate(sj))
    gs, gy = golden_chunked(jstate(s0j), x)
    np.testing.assert_allclose(yt.numpy(), gy, rtol=0, atol=FPLL_TOL)
    assert_state_close(st, gs)


@pytest.mark.parametrize("n", [4000, 300])
def test_fpll_chunked_tail_carries_the_last_valid_sample(n):
    """At n % 256 != 0 grtpu carries the state from the zero pad; the port
    from the last valid sample (the numpy golden); one call's output is
    causal and equals grtpu's."""
    x = pilot(4096)[:n]
    s0j = jr.fpll_init_state(IF_NORM * FS * 1.0002, FS)
    s0 = tr.state_from_numpy(tr.FpllState, jstate(s0j), CPU)
    st, yt = tr.fpll_chunked(s0, t(x), FS)
    gs, gy = golden_chunked(jstate(s0j), x)
    assert_state_close(st, gs)
    np.testing.assert_allclose(yt.numpy(), gy, rtol=0, atol=FPLL_TOL)
    sj, yj = jr.fpll_chunked(s0j, jnp.asarray(x), FS)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=FPLL_TOL)
    # grtpu's carried state is the pad's, off the golden
    assert max(abs(float(a) - b) for a, b in zip(jstate(sj), gs)) > 1e-3


def test_fpll_chunked_streamed_against_golden():
    """Two calls, the first not a multiple of the chunk: the second call
    continues from the first's last sample (no phase jump)."""
    x = pilot(4096, seed=6)
    s0 = tr.fpll_init_state(IF_NORM * FS * 1.0002, FS, CPU)
    s1, y1 = tr.fpll_chunked(s0, t(x[:1000]), FS)
    s2, y2 = tr.fpll_chunked(s1, t(x[1000:]), FS)
    g1, gy1 = golden_chunked(jstate(s0), x[:1000])
    g2, gy2 = golden_chunked(g1, x[1000:])
    np.testing.assert_allclose(np.concatenate([y1.numpy(), y2.numpy()]),
                               np.concatenate([gy1, gy2]), rtol=0,
                               atol=FPLL_TOL)
    assert_state_close(s2, g2)


def test_fpll_chunked_resumes_from_grtpu_state(fpll_chunked_j):
    """The port continues a stream from grtpu's carried FPLL state."""
    x = pilot(8192, seed=7)
    s0j = jr.fpll_init_state(IF_NORM * FS * 1.0003, FS)
    mid, _ = fpll_chunked_j(s0j, jnp.asarray(x[:4096]))
    endj, yj = fpll_chunked_j(mid, jnp.asarray(x[4096:]))
    st, yt = tr.fpll_chunked(
        tr.state_from_numpy(tr.FpllState, jstate(mid), CPU), t(x[4096:]), FS)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=FPLL_TOL)
    assert_state_close(st, jstate(endj))


def test_remove_dc_within_bound():
    x = pilot(4096) + 0.5
    yj, dj = jax.jit(jr.remove_dc)(jnp.asarray(x), jnp.float32(0.1))
    yt, dt = tr.remove_dc(t(x), 0.1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    assert abs(float(dt) - float(dj)) < 1e-6


# ----------------------------------------------------------------- RF: BTL
@pytest.fixture(scope="module")
def btl_case():
    """grtpu's own 30-segment test stream (test_atsc_rf.py) and grtpu's run
    of it, whole and in two halves."""
    from grtpu.ops.fir import interp_fir_filter
    from grtpu.utils import firdes

    r = np.random.default_rng(42)
    segs = r.choice([-7, -5, -3, -1, 1, 3, 5, 7], size=(30, 832)).astype(
        np.float32)
    segs[:, :4] = [5, -5, -5, 5]
    rrc = firdes.root_raised_cosine(2.0, 2.0, 1.0, 0.115, 41).astype(
        np.float32)
    xs = np.array(interp_fir_filter(jnp.concatenate(
        [jnp.zeros(20, jnp.float32), jnp.asarray(segs.reshape(-1))]),
        jnp.asarray(rrc), 2))
    nseg = int((len(xs) - jr.BTL_WINDOW) // (2.0 * 832))
    whole = jr.bit_timing_loop(jr.btl_init_state(2.0), jnp.asarray(xs), nseg)
    half = jr.bit_timing_loop(jr.btl_init_state(2.0), jnp.asarray(xs), 14)
    return xs, nseg, whole, half


def assert_btl_equal(got, want):
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for f, g, w in zip(tr.BtlState._fields, got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def test_bit_timing_loop_identical(btl_case):
    xs, nseg, whole, _ = btl_case
    got = tr.bit_timing_loop(tr.btl_init_state(2.0, CPU), t(xs), nseg)
    assert_btl_equal(got, whole)
    assert got[3][-5:].all()


def test_bit_timing_loop_resumes_from_grtpu_state(btl_case):
    xs, nseg, whole, half = btl_case
    st = tr.state_from_numpy(tr.BtlState, jstate(half[0]), CPU)
    base = int(half[5])
    got = tr.bit_timing_loop(st, t(xs[base:]), nseg - 14)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(whole[1])[14 * 832:])
    for k in (2, 3, 4):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(whole[k])[14:])
    for f, g, w in zip(tr.BtlState._fields, got[0], whole[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def test_fs_correlate_identical():
    r = np.random.default_rng(12)
    data = r.integers(0, 8, (630, 828)).astype(np.uint8)
    stream = tr.AtscFieldSyncMux()(data).astype(np.float32) * 2 - 7
    stream[10:16] = -stream[10:16]
    tj, fj = jr.fs_correlate(jnp.asarray(stream))
    tg, fg = tr.fs_correlate(t(stream))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(fj))
    pos = np.nonzero(tg.numpy())[0]
    assert list(pos[:3]) == [0, 313 * 832, 2 * 313 * 832]


# ----------------------------------------------------------- RF: equalizers
@pytest.fixture(scope="module")
def multipath_fields():
    """Two fields through grtpu's test channel (1 + 0.45 z^-60 + 0.2
    z^-150, noise 0.05), each as the window an equalizer takes."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 8, (2 * 312, 828)).astype(np.uint8)
    stream = tr.AtscFieldSyncMux()(data).astype(np.float32) * 2 - 7
    h = np.zeros(151, np.float32)
    h[0], h[60], h[150] = 1.0, 0.45, 0.2
    x = np.convolve(stream, h)[: len(stream)].astype(np.float32)
    x += 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    xp = np.concatenate([np.zeros(tr.EQ_CURSOR, np.float32), x,
                         np.zeros(tr.EQ_NTAPS, np.float32)])
    n = tr.SYMBOLS_PER_FIELD + tr.EQ_NTAPS - 1
    return [xp[f * tr.SYMBOLS_PER_FIELD: f * tr.SYMBOLS_PER_FIELD + n]
            for f in range(2)], data


def slicer(y):
    return np.clip(np.round((np.asarray(y) + 7) / 2), 0, 7)


def assert_decisions_equal(got, want):
    """Slicer decisions identical wherever grtpu's output lies farther than
    EQ_TOL from a decision boundary (the even levels -6..6): two outputs
    within EQ_TOL of each other can straddle a boundary only there."""
    want = np.asarray(want)
    edge = np.abs(want[..., None] - np.arange(-6.0, 7.0, 2.0)).min(-1)
    clear = edge > EQ_TOL
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(slicer(got)[clear], slicer(want)[clear])


def test_lms_train_and_filter_within_bound(multipath_fields):
    xf = multipath_fields[0][0]
    taps = np.zeros(tr.EQ_NTAPS, np.float32)
    taps[tr.EQ_CURSOR] = 0.9
    d = tr.fs_training_levels(0)
    xt = xf[: tr.FS_TRAIN_LEN + tr.EQ_NTAPS - 1]
    tj, yj = jr._lms_train(jnp.asarray(taps), jnp.asarray(xt), jnp.asarray(d))
    tt_, yt = tr._lms_train(t(taps), t(xt), t(d))
    np.testing.assert_allclose(tt_.numpy(), np.asarray(tj), rtol=0,
                               atol=EQ_TOL)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=EQ_TOL)
    fj = np.asarray(jr._eq_filter(tj, jnp.asarray(xf[:6000])))
    ft = tr._eq_filter(t(np.asarray(tj)), t(xf[:6000])).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=EQ_TOL)


def test_dfe_train_and_filter_within_bound(multipath_fields):
    """Eight gear-shifted sweeps, then the feedback recursion (the twin of
    dfe_feedback_fwd) over 4000 symbols: taps and outputs within EQ_TOL,
    decisions identical."""
    xf = multipath_fields[0][0]
    d = tr.fs_training_levels(0)
    xt = xf[tr.EQ_CURSOR: tr.EQ_CURSOR + tr.FS_TRAIN_LEN + tr.DFE_NFF - 1]
    wff = np.zeros(tr.DFE_NFF, np.float32)
    wff[0] = 0.9
    wj, bj = jnp.asarray(wff), jnp.zeros(tr.DFE_NFB, jnp.float32)
    wt, bt = t(wff), torch.zeros(tr.DFE_NFB)
    for s in range(8):
        mu = 0.25 * (0.5 ** max(0, s - 4))
        wj, bj = jr._dfe_train(wj, bj, jnp.asarray(xt), jnp.asarray(d),
                               jnp.float32(mu))
        wt, bt = tr._dfe_train(wt, bt, t(xt), t(d), mu)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=EQ_TOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=EQ_TOL)
    xff = xf[tr.EQ_CURSOR: tr.EQ_CURSOR + 4000 + tr.DFE_NFF - 1]
    yj = np.asarray(jr._dfe_filter(wj, bj, jnp.asarray(xff),
                                   jnp.zeros(tr.DFE_NFB, jnp.float32)))
    yt = tr._dfe_filter(t(np.asarray(wj)), t(np.asarray(bj)), t(xff),
                        torch.zeros(tr.DFE_NFB)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=EQ_TOL)
    assert_decisions_equal(yt, yj)


@pytest.mark.parametrize("kind", ["nlms", "lms2", "nop"])
def test_equalizer_full_field(multipath_fields, kind):
    """One whole field from a fresh equalizer: outputs within EQ_TOL and
    decisions identical to grtpu's (a decision of the decision-feedback
    equalizer that flipped would feed back and move later outputs far past
    EQ_TOL)."""
    (xf, _), _ = multipath_fields
    want = jr.EQUALIZERS[kind]().process_field(xf)
    got = tr.EQUALIZERS[kind](device=CPU).process_field(xf)
    np.testing.assert_allclose(got, want, rtol=0, atol=EQ_TOL)
    assert_decisions_equal(got, want)


def test_lms_equalizer_resumes_from_grtpu_taps(multipath_fields):
    (xf1, xf2), _ = multipath_fields
    eq_j = jr.AtscEqualizerLms()
    eq_j.process_field(xf1)
    eq_t = tr.AtscEqualizerLms(device=CPU)
    eq_t.load(np.asarray(eq_j.taps))
    want = eq_j.process_field(xf2)
    got = eq_t.process_field(xf2)
    np.testing.assert_allclose(got, want, rtol=0, atol=EQ_TOL)
    np.testing.assert_allclose(eq_t.taps.numpy(), np.asarray(eq_j.taps),
                               rtol=0, atol=EQ_TOL)


def test_dfe_equalizer_resumes_from_grtpu_taps(multipath_fields):
    """The port's DFE loaded with grtpu's taps trains on the next field's
    sync to grtpu's taps."""
    (xf1, xf2), _ = multipath_fields
    eq_j = jr.AtscEqualizerDfe()
    eq_j.process_field(xf1)
    eq_t = tr.AtscEqualizerDfe(device=CPU)
    eq_t.load(np.asarray(eq_j.wff), np.asarray(eq_j.wfb))
    d = tr.fs_training_levels(1)
    xt = xf2[tr.EQ_CURSOR: tr.EQ_CURSOR + tr.FS_TRAIN_LEN + tr.DFE_NFF - 1]
    wj, bj = eq_j.wff, eq_j.wfb
    wt, bt = eq_t.wff, eq_t.wfb
    for s in range(8):
        mu = 0.25 * (0.5 ** max(0, s - 4))
        wj, bj = jr._dfe_train(wj, bj, jnp.asarray(xt), jnp.asarray(d),
                               jnp.float32(mu))
        wt, bt = tr._dfe_train(wt, bt, t(xt), t(d), mu)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=EQ_TOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=EQ_TOL)


def test_rf_receiver_equalizer_selection():
    rx = tr.AtscRfReceiver(fs=FS, if_freq=IF_NORM * FS, ratio=RATIO,
                           equalizer="lms2", device=CPU)
    assert isinstance(rx.eq, tr.AtscEqualizerDfe)
    np.testing.assert_array_equal(
        rx.pb_rrc, jr.AtscRfReceiver(fs=FS, if_freq=IF_NORM * FS,
                                     ratio=RATIO).pb_rrc)
    assert isinstance(tr.AtscRfReceiver(fs=FS, if_freq=IF_NORM * FS,
                                        equalizer="nop", device=CPU).eq,
                      tr.AtscEqualizerNop)
    with pytest.raises(KeyError):
        tr.AtscRfReceiver(fs=FS, if_freq=IF_NORM * FS, equalizer="bogus",
                          device=CPU)


@pytest.mark.slow
def test_rf_transport_loopback():
    """Packets -> full TX coding -> VSB RF -> FPLL/BTL/FS/EQ -> packets on
    the CPU, grtpu's own gates (test_atsc_rf.py)."""
    from grtpu_torch.ops.fir import interp_fir_filter
    from grtpu_torch.utils import firdes

    rng = np.random.default_rng(42)
    npkt = int(312 * 2.3)
    payload = rng.integers(0, 256, (npkt, 187)).astype(np.uint8)
    pkts = np.concatenate([np.full((npkt, 1), 0x47, np.uint8), payload], 1)
    levels = ta.AtscTransmitter().process(pkts)
    codes = ((levels + 7) // 2).astype(np.uint8)
    nseg = len(codes) // 828
    stream = tr.AtscFieldSyncMux()(codes[: nseg * 828].reshape(nseg, 828))
    sym = stream.astype(np.float32) * 2 - 7 + 1.25
    rrc5 = firdes.root_raised_cosine(5.0, 5.0, 1.0, 0.115, 201).astype(
        np.float32)
    up5 = interp_fir_filter(torch.cat([torch.zeros(40), t(sym)]), rrc5,
                            5).numpy()
    passband = tr.vsb_modulate(up5[::2].astype(np.float64), IF_NORM, RATIO)
    fields = tr.AtscRfReceiver(fs=FS, if_freq=IF_NORM * FS, ratio=RATIO,
                               device=CPU).process(passband)
    assert len(fields) >= 1
    out, bad = ta.AtscReceiver(CPU).process(fields[0].reshape(-1))
    assert bad == 0
    matches = [sum(np.array_equal(out[i], pkts[k * 312 + i])
                   for i in range(min(len(out), npkt - k * 312)))
               for k in range(2)]
    assert max(matches) == len(out) == 260
