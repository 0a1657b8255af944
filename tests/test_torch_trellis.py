"""Parity of grtpu_torch.trellis with grtpu.trellis on the CPU.

The numpy modules (FSM, Interleaver, fsm_utils) are copies: their tables,
files and results are identical.  The algorithms get the same numpy inputs
from local seeds: the sequential and log-depth Viterbi (the sequential form
on a CPU tensor is ``viterbi_fwd``'s plain twin), the min-sum SISO and turbo
decoders and the FSM encoder are identical to grtpu (every step is a float32
add, compare or min in grtpu's order; integer metrics, where ties are the
rule, included); the sum-product forms differ from XLA's ``logsumexp`` by
its last-ulp ``exp``/``log``: posteriors within 1e-5, decisions identical.
The blocks run through the port's StreamExecutor, eagerly and under
``run(device_loop=True)``, against grtpu's blocks; a TrellisEncoder's state
crosses the packages through the executor's npz checkpoint both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grtpu
import grtpu.trellis as jt
import grtpu_torch
import grtpu_torch.trellis as tt
from grtpu.digital.constellation import constellation_qpsk as jqpsk
from grtpu_torch.digital.constellation import constellation_qpsk as tqpsk
from grtpu_torch.utils.testing import run_block

SP_TOL = 1e-5       # sum-product posteriors: XLA's exp/log vs torch's
JIT_TOL = 1e-5      # float block outputs against grtpu's jitted blocks

CONV = {"fsm4": (1, 2, [[0b101, 0b111]]), "k3": (1, 2, [[7, 5]]),
        "ccsds": (1, 2, [[0o117, 0o155]]), "r23": (2, 3, [[1, 0, 3], [0, 1, 1]])}
MSB = dict(NS=[0, 1, 2, 3] * 4,
           OS=[0, 5, 3, 6, 4, 1, 7, 2, 7, 2, 4, 1, 3, 6, 0, 5])


def both(name):
    """The same FSM built by each package."""
    if name in CONV:
        return tuple(m.FSM.from_convolutional(*CONV[name]) for m in (jt, tt))
    if name == "msb":
        return tuple(m.FSM(4, 4, 8, **MSB) for m in (jt, tt))
    if name == "isi":
        return tuple(m.FSM.from_isi(4, 3) for m in (jt, tt))
    if name == "cpm":
        return tuple(m.FSM.from_cpm(2, 2, 2) for m in (jt, tt))
    if name == "product":
        return tuple(m.FSM.from_product(m.FSM.from_convolutional(*CONV["k3"]),
                                        m.FSM.from_isi(2, 2)) for m in (jt, tt))
    if name == "radix2":
        return tuple(m.FSM.from_convolutional(*CONV["fsm4"]).radix(2)
                     for m in (jt, tt))
    raise KeyError(name)


FSM_NAMES = ["fsm4", "k3", "ccsds", "r23", "msb", "isi", "cpm", "product",
             "radix2"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("name", FSM_NAMES)
def test_fsm_tables_identical(name):
    fj, ft = both(name)
    assert (fj.I, fj.S, fj.O) == (ft.I, ft.S, ft.O)
    for attr in ("NS", "OS", "PS", "PI", "TMl", "TMi"):
        np.testing.assert_array_equal(getattr(fj, attr), getattr(ft, attr))
    inputs = np.random.RandomState(1).randint(0, fj.I, 50)
    np.testing.assert_array_equal(fj.encode(inputs), ft.encode(inputs))
    es = fj.S - 1
    if fj.TMl[0, es] < fj.S:
        assert fj.termination_inputs(0, es) == ft.termination_inputs(0, es)


@pytest.mark.parametrize("name", ["fsm4", "ccsds", "isi"])
def test_fsm_file_round_trip_across_packages(tmp_path, name):
    fj, ft = both(name)
    pj, pt = tmp_path / "j.fsm", tmp_path / "t.fsm"
    fj.write_fsm_txt(str(pj))
    ft.write_fsm_txt(str(pt))
    assert pj.read_text() == pt.read_text()
    for back in (tt.FSM.from_file(str(pj)), jt.FSM.from_file(str(pt))):
        np.testing.assert_array_equal(back.NS, fj.NS)
        np.testing.assert_array_equal(back.OS, fj.OS)


def test_base_conversions_identical():
    for num, base, nd in ((37, 3, 5), (255, 2, 8), (0, 4, 3)):
        assert jt.dec2base(num, base, nd) == tt.dec2base(num, base, nd)
        assert tt.base2dec(tt.dec2base(num, base, nd), base) == num


@pytest.mark.parametrize("k,seed", [(64, 3), (512, 666), (1000, 0)])
def test_interleaver_identical(tmp_path, k, seed):
    ij, it = jt.Interleaver.random(k, seed), tt.Interleaver.random(k, seed)
    np.testing.assert_array_equal(ij.INTER, it.INTER)
    np.testing.assert_array_equal(ij.DEINTER, it.DEINTER)
    x = np.arange(k) * 3
    np.testing.assert_array_equal(it.deinterleave(it.interleave(x)), x)
    p = tmp_path / "il.txt"
    it.write_interleaver_txt(str(p))
    np.testing.assert_array_equal(jt.Interleaver.from_file(str(p)).INTER,
                                  it.INTER)
    with pytest.raises(ValueError):
        tt.Interleaver(4, [0, 1, 1, 3])


def test_fsm_utils_identical():
    ju, tu = jt.fsm_utils, tt.fsm_utils
    for name in ("pam2", "pam4", "pam8", "psk2", "psk4", "psk8", "orth2",
                 "orth4", "c_channel"):
        assert getattr(ju, name) == getattr(tu, name)
    assert ju.make_isi_lookup(ju.pam4, ju.c_channel[:3], True) == \
        tu.make_isi_lookup(tu.pam4, tu.c_channel[:3], True)
    q = np.linspace(0, 0.5, 16)
    for a, b in zip(ju.make_cpm_signals(1, 2, 2, 2, q),
                    tu.make_cpm_signals(1, 2, 2, 2, q)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ metrics
def test_metrics_identical():
    r = np.random.RandomState(2)
    obs = r.randn(40).astype(np.float32)
    pts = np.array([-1.5, -0.5, 0.5, 1.5], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jt.calc_metric_euclidean(jnp.asarray(obs), jnp.asarray(pts))),
        tt.calc_metric_euclidean(t(obs), pts).numpy())
    cobs = (r.randn(30) + 1j * r.randn(30)).astype(np.complex64)
    cpts = tqpsk().points
    np.testing.assert_allclose(
        np.asarray(jt.calc_metric_euclidean(jnp.asarray(cobs), jnp.asarray(cpts))),
        tt.calc_metric_euclidean(t(cobs), cpts).numpy(), rtol=1e-6, atol=1e-6)
    sym = r.randint(0, 4, 25)
    np.testing.assert_array_equal(
        np.asarray(jt.calc_metric_hard(jnp.asarray(sym), 4)),
        tt.calc_metric_hard(t(sym), 4).numpy())
    obs2 = r.randn(60).astype(np.float32)
    for mt in ("euclidean", "hard_symbol"):
        np.testing.assert_array_equal(
            np.asarray(jt.calc_metric_cost(jnp.asarray(obs2), pts.reshape(2, 2),
                                           2, mt)),
            tt.calc_metric_cost(t(obs2), pts.reshape(2, 2), 2, mt).numpy())


# ------------------------------------------------------------------ Viterbi
VIT = [("fsm4", 512, 0, -1), ("fsm4", 64, -1, -1), ("msb", 200, 0, 0),
       ("isi", 128, 0, -1), ("ccsds", 256, 0, -1), ("r23", 100, 1, 0)]


@pytest.mark.parametrize("name,k,st,en", VIT)
def test_viterbi_identical(name, k, st, en):
    fj, ft = both(name)
    r = np.random.RandomState(k + fj.S)
    m = r.rand(3, k, fj.O).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda row: jt.viterbi(fj, row, st, en)))(jnp.asarray(m)))
    got = tt.viterbi(ft, t(m), st, en)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_ties_take_the_first_index():
    """Integer metrics make ties the rule; the first index wins, as
    grtpu's argmax."""
    fj, ft = both("fsm4")
    m = np.random.RandomState(3).randint(0, 3, (4, 300, 4)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda row: jt.viterbi(fj, row, 0, -1)))(jnp.asarray(m)))
    np.testing.assert_array_equal(tt.viterbi(ft, t(m)).numpy(), want)


@pytest.mark.parametrize("name,k", [("fsm4", 512), ("msb", 64), ("isi", 97)])
def test_viterbi_parallel_identical(name, k):
    fj, ft = both(name)
    m = np.random.RandomState(k).rand(2, k, fj.O).astype(np.float32)
    f = jax.jit(lambda x: jt.viterbi(fj, x, 0, -1, parallel=True))
    want = np.stack([np.asarray(f(jnp.asarray(row))) for row in m])
    got = tt.viterbi(ft, t(m), 0, -1, parallel=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # on these metrics the latency form picks the sequential form's path
    np.testing.assert_array_equal(got.numpy(), tt.viterbi(ft, t(m)).numpy())
    with pytest.raises(ValueError):
        tt.viterbi(both("ccsds")[1], t(m[..., :4]), parallel=True)


def test_viterbi_hard_decodes_clean_and_combined():
    fj, ft = both("k3")
    r = np.random.RandomState(33)
    bits = r.randint(0, 2, 400)
    bits[-2:] = 0
    syms = ft.encode(bits)
    np.testing.assert_array_equal(
        tt.viterbi(ft, tt.calc_metric_hard(t(syms), 4), 0, 0).numpy(), bits)
    pts = np.exp(1j * (np.pi / 4 + np.pi / 2 * np.arange(4))).astype(
        np.complex64)
    rx = (pts[syms] + 0.3 * (r.randn(400) + 1j * r.randn(400))).astype(
        np.complex64)
    want = np.asarray(jt.viterbi_combined(fj, jnp.asarray(rx),
                                          jnp.asarray(pts), 1, 0, 0))
    got = tt.viterbi_combined(ft, t(rx), pts, 1, 0, 0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != bits).mean() < 0.01


def test_ccsds_fsm_decodes_the_dedicated_encoder():
    from grtpu_torch.fec.conv import conv_encode_27

    ft = both("ccsds")[1]
    bits = np.random.RandomState(33).randint(0, 2, 300).astype(np.uint8)
    bits[-6:] = 0
    enc = conv_encode_27(t(bits)).numpy()
    syms = (enc[0::2] << 1) | enc[1::2]
    dec = tt.viterbi(ft, tt.calc_metric_hard(t(syms), 4), 0, -1).numpy()
    np.testing.assert_array_equal(dec, bits)


# --------------------------------------------------------------------- SISO
def test_siso_identical():
    fj, ft = both("fsm4")
    r = np.random.RandomState(4)
    m = (r.rand(2, 150, 4) * 3).astype(np.float32)
    pri = r.rand(2, 150, 2).astype(np.float32)
    for st, en in ((0, 0), (0, -1)):
        want = np.asarray(jax.jit(jax.vmap(
            lambda a, b: jt.siso(fj, a, st, en, b)))(jnp.asarray(m),
                                                      jnp.asarray(pri)))
        got = tt.siso(ft, t(m), st, en, t(pri)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sum_product", [False, True], ids=["min_sum", "sum_product"])
@pytest.mark.parametrize("parallel", [None, True], ids=["scan", "log_depth"])
@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)],
                         ids=["posti", "posto", "both"])
def test_siso_cost_identical(sum_product, parallel, flags):
    fj, ft = both("msb")
    r = np.random.RandomState(5)
    pri = (r.rand(2, 96, 4) * 2).astype(np.float32)
    pro = (r.rand(2, 96, 8) * 4).astype(np.float32)
    f = jax.jit(lambda a, b: jt.siso_cost(
        fj, a, b, 0, -1, posti=flags[0], posto=flags[1],
        sum_product=sum_product, parallel=parallel))
    want = [f(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(pri, pro)]
    got = tt.siso_cost(ft, t(pri), t(pro), 0, -1, posti=flags[0],
                       posto=flags[1], sum_product=sum_product,
                       parallel=parallel)
    if not isinstance(got, tuple):
        got, want = (got,), [(w,) for w in want]
    tol = SP_TOL if sum_product else 0.0
    for i, g in enumerate(got):
        w = np.stack([np.asarray(x[i]) for x in want])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


# -------------------------------------------------------------------- turbo
FSM_PAIR = {"sccc": ("fsm4", "msb"), "pccc": ("fsm4", "fsm4")}


@pytest.mark.parametrize("sum_product", [False, True], ids=["min_sum", "sum_product"])
@pytest.mark.parametrize("kind", ["sccc", "pccc"])
def test_turbo_decoders_identical(kind, sum_product):
    (o_j, o_t), (i_j, i_t) = (both(n) for n in FSM_PAIR[kind])
    k = 64
    il_j, il_t = jt.Interleaver.random(k, 666), tt.Interleaver.random(k, 666)
    width = i_j.O if kind == "sccc" else o_j.O * i_j.O
    m = np.random.RandomState(6).rand(3, k, width).astype(np.float32)
    dec_j = jt.sccc_decoder if kind == "sccc" else jt.pccc_decoder
    dec_t = tt.sccc_decoder if kind == "sccc" else tt.pccc_decoder
    want = np.asarray(jax.jit(jax.vmap(lambda x: dec_j(
        o_j, i_j, il_j, x, 4, sum_product=sum_product)))(jnp.asarray(m)))
    got = dec_t(o_t, i_t, il_t, t(m), 4, sum_product=sum_product)
    np.testing.assert_array_equal(got.numpy(), want)


def _sccc_channel(k, nblk, snr_noise, seed):
    """Random bits -> SCCC (FSM4 outer, the rate-2/3 inner) -> 8-PAM-ish
    levels + noise, as numpy."""
    r = np.random.RandomState(seed)
    bits = r.randint(0, 2, (nblk, k))
    il = tt.Interleaver.random(k, 666)
    fo, fi = both("fsm4")[1], both("msb")[1]
    _, mid = tt.fsm_encode(fo, t(bits), 0)
    _, sym = tt.fsm_encode(fi, mid[:, torch.from_numpy(il.INTER).long()], 0)
    table = np.arange(8, dtype=np.float32) - 3.5
    obs = table[sym.numpy()] + snr_noise * r.randn(nblk, k).astype(np.float32)
    return bits, obs.astype(np.float32), table


@pytest.mark.parametrize("kind", ["sccc", "pccc"])
def test_combined_decoders_recover_bits(kind):
    k = 256
    if kind == "sccc":
        bits, obs, table = _sccc_channel(k, 2, 0.15, 7)
        fo, fi = both("fsm4"), both("msb")
    else:
        r = np.random.RandomState(8)
        bits = r.randint(0, 2, (2, k))
        il = tt.Interleaver.random(k, 666)
        f4 = both("fsm4")[1]
        _, o1 = tt.fsm_encode(f4, t(bits), 0)
        _, o2 = tt.fsm_encode(f4, t(bits)[:, torch.from_numpy(il.INTER).long()],
                              0)
        table = np.arange(16, dtype=np.float32) - 7.5
        obs = (table[(o1 * 4 + o2).numpy()]
               + 0.15 * r.randn(2, k)).astype(np.float32)
        fo, fi = both("fsm4"), both("fsm4")
    il_j, il_t = jt.Interleaver.random(k, 666), tt.Interleaver.random(k, 666)
    dec_j = (jt.sccc_decoder_combined if kind == "sccc"
             else jt.pccc_decoder_combined)
    dec_t = (tt.sccc_decoder_combined if kind == "sccc"
             else tt.pccc_decoder_combined)
    got = dec_t(fo[1], fi[1], il_t, t(obs), table, 1, "euclidean", 1.0, 4)
    f = jax.jit(lambda x: dec_j(fo[0], fi[0], il_j, x, jnp.asarray(table), 1,
                                "euclidean", 1.0, 4))
    want = np.stack([np.asarray(f(jnp.asarray(row))) for row in obs])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("name", ["fsm4", "isi", "ccsds"])
def test_fsm_encode_identical(name):
    fj, ft = both(name)
    x = np.random.RandomState(9).randint(0, fj.I, (3, 333))
    for st in (0, fj.S - 1):
        got_s, got = tt.fsm_encode(ft, t(x), st)
        for row, gs, g in zip(x, got_s, got):
            ws, w = jt.fsm_encode(fj, jnp.asarray(row), st)
            assert int(ws) == int(gs)
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ------------------------------------------------------------------- blocks
K = 64


def _jblock_out(blk, x):
    """grtpu's block on the whole input, jitted as grtpu's executor runs
    it."""
    _, y = jax.jit(blk.apply)(blk.init_state(), jnp.asarray(x))
    return np.asarray(y)


def _block_pairs():
    f4j, f4t = both("fsm4")
    msj, mst = both("msb")
    ilj, ilt = jt.Interleaver.random(K, 5), tt.Interleaver.random(K, 5)
    pam = np.array([-1.5, -0.5, 0.5, 1.5], np.float32)
    r = np.random.RandomState(10)
    bits = r.randint(0, 2, 4 * K).astype(np.int32)
    costs4 = (r.rand(4 * K * 4) * 3).astype(np.float32)
    costs8 = (r.rand(4 * K * 8) * 3).astype(np.float32)
    costs16 = (r.rand(4 * K * 16) * 3).astype(np.float32)
    obs = r.randn(4 * K).astype(np.float32)
    cobs = (r.randn(4 * K) + 1j * r.randn(4 * K)).astype(np.complex64)
    table8 = np.arange(8, dtype=np.float32) - 3.5
    return {
        "pccc_encoder": (lambda m, fa, fb, il: m.PcccEncoder(fa, 0, fa, 0, il, K),
                         (f4j, f4j, ilj), (f4t, f4t, ilt), bits),
        "sccc_encoder": (lambda m, fa, fb, il: m.ScccEncoder(fa, 0, fb, 0, il, K),
                         (f4j, msj, ilj), (f4t, mst, ilt), bits),
        "permutation": (lambda m, fa, fb, il: m.Permutation(K, il.INTER, 1),
                        (f4j, msj, ilj), (f4t, mst, ilt), obs),
        "trellis_metrics": (lambda m, fa, fb, il: m.TrellisMetrics(4, 1, pam),
                            (f4j, msj, ilj), (f4t, mst, ilt), obs),
        "viterbi_decoder": (lambda m, fa, fb, il: m.ViterbiDecoder(fa, K, 0, -1),
                            (f4j, msj, ilj), (f4t, mst, ilt), costs4),
        "viterbi_combined": (lambda m, fa, fb, il: m.ViterbiCombined(
            fa, K, 0, -1, 1, np.array([1, 1j, -1j, -1], np.complex64)),
            (f4j, msj, ilj), (f4t, mst, ilt), cobs),
        "siso_posti": (lambda m, fa, fb, il: m.SisoF(fa, K, 0, -1, True),
                       (f4j, msj, ilj), (f4t, mst, ilt), costs4),
        "siso_combined_posto": (lambda m, fa, fb, il: m.SisoCombinedF(
            fb, K, 0, -1, 1, table8, posti=False),
            (f4j, msj, ilj), (f4t, mst, ilt), obs),
        "sccc_decoder": (lambda m, fa, fb, il: m.ScccDecoder(
            fa, 0, -1, fb, 0, -1, il, K, 2), (f4j, msj, ilj), (f4t, mst, ilt),
            costs8),
        "sccc_decoder_combined": (lambda m, fa, fb, il: m.ScccDecoderCombined(
            fa, 0, -1, fb, 0, -1, il, K, 1, table8, iterations=2,
            complex_in=False), (f4j, msj, ilj), (f4t, mst, ilt), obs),
        "pccc_decoder": (lambda m, fa, fb, il: m.PcccDecoder(
            fa, 0, -1, fa, 0, -1, il, K, 2), (f4j, msj, ilj), (f4t, mst, ilt),
            costs16),
        "pccc_decoder_combined": (lambda m, fa, fb, il: m.PcccDecoderCombined(
            fa, 0, -1, fa, 0, -1, il, K, 1, np.arange(16, dtype=np.float32),
            iterations=2, complex_in=False),
            (f4j, msj, ilj), (f4t, mst, ilt), obs),
    }


BLOCKS = _block_pairs()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_identical_through_the_executor(name):
    """Each block through the port's executor (two chunks of two K-blocks),
    eagerly and under device_loop, against grtpu's jitted block on the
    whole input: decisions identical; float outputs within JIT_TOL (under
    jit XLA fuses the combined SISO's metric arithmetic into its
    recursion: 3.8e-6 from grtpu's own eager result, which the port equals
    bit for bit)."""
    make, jargs, targs, x = BLOCKS[name]
    want = _jblock_out(make(jt, *jargs), x)
    blk = make(tt, *targs)
    chunk = len(x) // 2
    g = grtpu_torch.Graph()
    g.connect(g.add_input(blk.in_ports[0]), make(tt, *targs),
              g.add_output(blk.out_ports[0]))
    ex = grtpu_torch.StreamExecutor(g, chunk_size=chunk, device="cpu")
    for got in (run_block(blk, x, chunk_size=chunk, device="cpu"),
                ex.run(t(x), device_loop=True).numpy()):
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=JIT_TOL)
        else:
            np.testing.assert_array_equal(got, want)


def test_constellation_metrics_takes_a_constellation_object():
    """grtpu's block calls ``constellation.points()``, which is an array on
    its constellations: the port takes the object's points (or the points
    themselves); parity against grtpu's block given the points."""
    cobs = (np.random.RandomState(11).randn(50)
            + 1j * np.random.RandomState(12).randn(50)).astype(np.complex64)
    want = _jblock_out(jt.ConstellationMetrics(jqpsk().points), cobs)
    for arg in (tqpsk(), tqpsk().points):
        got = run_block(tt.ConstellationMetrics(arg), cobs, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_trellis_encoder_streams_state():
    f4j, f4t = both("fsm4")
    bits = np.random.default_rng(0).integers(0, 2, 256).astype(np.int32)
    got = run_block(tt.TrellisEncoder(f4t), bits, chunk_size=64, device="cpu")
    np.testing.assert_array_equal(got, f4t.encode(bits))
    np.testing.assert_array_equal(
        got, _jblock_out(jt.TrellisEncoder(f4j), bits))


@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")],
                         ids=["grtpu-to-port", "port-to-grtpu"])
def test_encoder_state_moves_between_packages(tmp_path, writer, reader):
    f4 = {"j": both("fsm4")[0], "t": both("fsm4")[1]}
    x = np.random.default_rng(2).integers(0, 2, 1024).astype(np.int32)
    chunk = 512

    def go(k, inputs, load=None, save=None):
        pkg, mod = (grtpu, jt) if k == "j" else (grtpu_torch, tt)
        blk = mod.TrellisEncoder(f4[k], 1)
        g = pkg.Graph()
        g.connect(g.add_input(blk.in_ports[0]), blk,
                  g.add_output(blk.out_ports[0]))
        kw = {} if k == "j" else {"device": "cpu"}
        ex = pkg.StreamExecutor(g, chunk_size=chunk, **kw)
        if load:
            ex.load_checkpoint(load)
        y = ex.run(jnp.asarray(inputs) if k == "j" else t(inputs))
        if save:
            ex.save_checkpoint(save)
        return np.asarray(y) if k == "j" else y.numpy()

    path = str(tmp_path / "state.npz")
    full = go(writer, x)
    go(writer, x[:chunk], save=path)
    np.testing.assert_array_equal(go(reader, x[chunk:], load=path),
                                  full[chunk:])
