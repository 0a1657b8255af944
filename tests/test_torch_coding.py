"""grtpu_torch's scramblers, LFSRs, equalizers, CPM, modem registry and
BERT, held against grtpu on the CPU.

Scrambler and LFSR outputs, registers and positions are compared exactly
(tests/test_coding.py:183-250's scenarios, plus carried state across
calls); the equalizers to atol 1e-5 (tests/test_digital.py:259-338), the
kurtotic one on an input whose kurtosis sign is not at a rounding boundary
(on constant-modulus QPSK it is: there its sign is set by the last bit of
a sum, so the port is held to its own full-stream run, as grtpu is);
CPM to atol 1e-5 (tests/test_apps.py:88-110); BERT at its bits, probe and
gates (tests/test_apps.py:249-290) on a shorter stream.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
from grtpu.digital import bert as jbert  # noqa: E402
from grtpu.digital import constellation as jcon  # noqa: E402
from grtpu.digital import cpm as jcpm  # noqa: E402
from grtpu.digital import equalizers as jeq  # noqa: E402
from grtpu.digital import lfsr as jlfsr  # noqa: E402
from grtpu.digital import modulation_utils as jmu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu_torch.digital import bert as tbert  # noqa: E402
from grtpu_torch.digital import constellation as tcon  # noqa: E402
from grtpu_torch.digital import cpm as tcpm  # noqa: E402
from grtpu_torch.digital import equalizers as teq  # noqa: E402
from grtpu_torch.digital import lfsr as tlfsr  # noqa: E402
from grtpu_torch.digital import modems as tmodems  # noqa: E402
from grtpu_torch.digital import modulation_utils as tmu  # noqa: E402
from grtpu_torch.ops import dsp as tdsp  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def bits(n, seed):
    return np.random.RandomState(seed).randint(0, 2, n).astype(np.uint8)


def gri_scramble(x, mask, seed, L):
    reg, y = seed, []
    for b in x:
        y.append(reg & 1)
        newbit = (bin(reg & mask).count("1") & 1) ^ (int(b) & 1)
        reg = (reg >> 1) | (newbit << L)
    return np.array(y, np.uint8), reg


def gri_descramble(x, mask, seed, L):
    reg, y = seed, []
    for b in x:
        y.append((bin(reg & mask).count("1") & 1) ^ (int(b) & 1))
        reg = (reg >> 1) | ((int(b) & 1) << L)
    return np.array(y, np.uint8), reg


# ---------------------------------------------------------------- LFSRs
def test_lfsr_host_sequences_identical():
    for deg in (5, 7, 9):
        m = tlfsr.GLFSR.default_mask(deg)
        assert m == jlfsr.GLFSR.default_mask(deg)
        np.testing.assert_array_equal(tlfsr.GLFSR(m, 1).sequence(200),
                                      jlfsr.GLFSR(m, 1).sequence(200))
    a, b = tlfsr.FibonacciLfsr(0x8A, 0x7F, 7), jlfsr.FibonacciLfsr(0x8A, 0x7F, 7)
    np.testing.assert_array_equal(a.sequence(300), b.sequence(300))
    assert a.period() == b.period()


def test_glfsr_period():
    seq = tlfsr.GLFSR(tlfsr.GLFSR.default_mask(5), 1).sequence(62)
    np.testing.assert_array_equal(seq[:31], seq[31:])
    assert seq[:31].sum() == 16


@pytest.mark.parametrize("dtype", ["b", "f"])
def test_glfsr_source(dtype):
    jd, td = {"b": (jnp.uint8, torch.uint8),
              "f": (jnp.float32, torch.float32)}[dtype]
    ys = []
    for pkg, lf, d in ((grtpu, jlfsr, jd), (grtpu_torch, tlfsr, td)):
        g = pkg.Graph()
        src = lf.GlfsrSource(6, dtype=d)
        g.connect(src, g.add_output(src.out_ports[0]))
        kw = {"device": "cpu"} if pkg is grtpu_torch else {}
        ys.append(out(pkg.StreamExecutor(g, chunk_size=50, **kw).run(steps=4)))
    assert ys[1].dtype == ys[0].dtype
    np.testing.assert_array_equal(ys[1], ys[0])


@pytest.mark.parametrize("mask,seed,L", [(0x8A, 0x7F, 7), (0x21, 0x1, 5)])
@pytest.mark.parametrize("n", [257, 1300])
def test_multiplicative_scramblers_bit_exact(mask, seed, L, n):
    """gri_lfsr.h:113-132, in calls of uneven length with the register
    carried: the port equals the host emulation and grtpu, register
    included (the 1300-bit calls span several GF(2) blocks)."""
    x = bits(n, L)
    for cls, gri in ((tlfsr.Scrambler, gri_scramble),
                     (tlfsr.Descrambler, gri_descramble)):
        want, reg = gri(x, mask, seed, L)
        blk = cls(mask, seed, L)
        st, parts = blk.init_state(), []
        for a, b in ((0, 100), (100, 101), (101, n)):
            st, y = blk.apply(st, t(x[a:b]))
            parts.append(y.numpy())
        np.testing.assert_array_equal(np.concatenate(parts), want)
        assert int(st) == reg
        jblk = getattr(jlfsr, cls.__name__)(mask, seed, L)
        _, yj = jblk.apply(jblk.init_state(), jnp.asarray(x))
        np.testing.assert_array_equal(np.concatenate(parts), np.asarray(yj))


def test_scrambler_descrambler_graph():
    """tests/test_coding.py:170-181: scramble -> descramble in a graph
    restores the stream after the register's 8-bit delay."""
    x = bits(1000, 3)
    g = grtpu_torch.Graph()
    g.connect(g.add_input(grtpu_torch.Port(torch.uint8)),
              tlfsr.Scrambler(0x8A, 0x7F, 7), tlfsr.Descrambler(0x8A, 0x7F, 7),
              g.add_output(grtpu_torch.Port(torch.uint8)))
    y = out(grtpu_torch.StreamExecutor(g, chunk_size=100, device="cpu").run(x))
    np.testing.assert_array_equal(y[8:], x[:-8])


@pytest.mark.parametrize("count", [0, 100])
def test_additive_scrambler(count):
    """gr_additive_scrambler_bb with and without reset; the carried
    position folds into the prefix-then-cycle sequence as grtpu's does."""
    x = bits(700, 4)
    tb, jb = (tlfsr.AdditiveScrambler(0x8A, 0x7F, 7, count),
              jlfsr.AdditiveScrambler(0x8A, 0x7F, 7, count))
    assert (tb.prefix_len, tb.cycle_len) == (jb.prefix_len, jb.cycle_len)
    np.testing.assert_array_equal(tb.seq, jb.seq)
    st, sj, parts, jparts = tb.init_state(), jb.init_state(), [], []
    for a, b in ((0, 1), (1, 300), (300, 700)):
        st, y = tb.apply(st, t(x[a:b]))
        sj, yj = jb.apply(sj, jnp.asarray(x[a:b]))
        parts.append(y.numpy())
        jparts.append(np.asarray(yj))
        assert st.dtype == torch.int32 and int(st) == int(sj)
    np.testing.assert_array_equal(np.concatenate(parts),
                                  np.concatenate(jparts))


# ----------------------------------------------------------- equalizers
def _qpsk_through(h, n, seed):
    c = jcon.constellation_qpsk()
    syms = c.points[np.random.RandomState(seed).randint(0, 4, n)]
    return np.convolve(syms.astype(np.complex64), h)[:n].astype(np.complex64)


def _history(x, ntaps):
    return np.concatenate([np.zeros(ntaps - 1, np.complex64), x])


def test_cma_equalizer():
    rx = _qpsk_through(np.array([1.0, 0.0, 0.25 - 0.12j], np.complex64),
                       3000, 5)
    xh = _history(rx, 11)
    yj, tj = jeq.cma_equalize(jnp.asarray(xh),
                              jnp.asarray(jeq.center_spike_taps(11)), 1.0,
                              0.005)
    yt, tt = teq.cma_equalize(t(xh), t(teq.center_spike_taps(11)), 1.0,
                              0.005)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    y = yt.numpy()
    before = np.abs(np.abs(rx[1500:]) ** 2 - 1.0).mean()
    after = np.abs(np.abs(y[1500:]) ** 2 - 1.0).mean()
    assert after < before * 0.5, (before, after)


def test_lms_dd_equalizer():
    c = tcon.constellation_qpsk()
    rx = _qpsk_through(np.array([1.0, 0.2 + 0.1j], np.complex64), 3000, 6)
    xh = _history(rx, 9)
    yj, tj = jeq.lms_dd_equalize(jnp.asarray(xh),
                                 jnp.asarray(jeq.center_spike_taps(9)),
                                 jnp.asarray(c.points), 0.01)
    yt, tt = teq.lms_dd_equalize(t(xh), t(teq.center_spike_taps(9)),
                                 t(c.points), 0.01)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    y = yt.numpy()[2000:]
    evm = np.abs(y - c.points[c.decision_maker(y).numpy()]).mean()
    r0 = rx[2000:]
    evm0 = np.abs(r0 - c.points[c.decision_maker(r0).numpy()]).mean()
    assert evm < evm0 * 0.5, (evm0, evm)


def test_kurtotic_equalizer_against_grtpu():
    rng = np.random.RandomState(7)
    x = (rng.randn(600) + 1j * rng.randn(600)).astype(np.complex64)
    xh = _history(x, 11)
    t0 = np.zeros(11, np.complex64)
    t0[0] = 1.0
    st = (np.float32(0), np.complex64(0), np.float32(0))
    yj, tj, sj = jeq.kurtotic_equalize(jnp.asarray(xh), jnp.asarray(t0),
                                       0.002, tuple(jnp.asarray(v) for v in st))
    yt, tt, stt = teq.kurtotic_equalize(t(xh), t(t0), 0.002,
                                        tuple(torch.tensor(v) for v in st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    for a, b in zip(stt, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_kurtotic_block_in_graph():
    """tests/test_digital.py:299-338 on the port: the chunked executor run
    equals one full-stream call (taps and moments carried across chunks),
    with finite, bounded output."""
    rx = _qpsk_through(np.array([1.0, 0.22 - 0.11j], np.complex64), 2048, 8)
    g = grtpu_torch.Graph()
    blk = teq.KurtoticEqualizer(num_taps=11, mu=0.002)
    g.connect(g.add_input(blk.in_ports[0]), blk,
              g.add_output(blk.out_ports[0]))
    y = out(grtpu_torch.StreamExecutor(g, chunk_size=512, device="cpu").run(rx))
    taps, stats = blk.init_state()
    y_full, _, _ = teq.kurtotic_equalize(t(_history(rx, 11)), taps, 0.002,
                                         stats)
    np.testing.assert_allclose(y, y_full.numpy(), atol=2e-4)
    assert np.all(np.isfinite(y)) and np.abs(y).max() < 100.0


@pytest.mark.parametrize("name", ["cma", "lms"])
def test_equalizer_blocks_against_grtpu(name):
    rx = _qpsk_through(np.array([1.0, 0.15 - 0.1j], np.complex64), 1024, 9)
    ys = []
    for pkg, eq, con in ((grtpu, jeq, jcon), (grtpu_torch, teq, tcon)):
        blk = (eq.CmaEqualizer(11, 1.0, 0.005) if name == "cma" else
               eq.LmsDdEqualizer(con.constellation_qpsk(), 11, 0.01))
        g = pkg.Graph()
        g.connect(g.add_input(blk.in_ports[0]), blk,
                  g.add_output(blk.out_ports[0]))
        kw = {"device": "cpu"} if pkg is grtpu_torch else {}
        ys.append(out(pkg.StreamExecutor(g, chunk_size=256, **kw).run(rx)))
    np.testing.assert_allclose(ys[1], ys[0], atol=1e-5)


# ------------------------------------------------------------------- CPM
@pytest.mark.parametrize("shape", ["LREC", "LRC", "LSRC", "TFM", "GAUSSIAN"])
def test_cpm_phase_response_identical(shape):
    np.testing.assert_array_equal(tcpm.phase_response(shape, 4, 2, 0.3),
                                  jcpm.phase_response(shape, 4, 2, 0.3))


@pytest.mark.parametrize("shape", ["LREC", "LRC", "GAUSSIAN"])
def test_cpm_modulator(shape):
    """tests/test_apps.py:88-103: unit modulus, pi*h phase advance a
    symbol, and the samples of grtpu's modulator."""
    syms = np.random.RandomState(10).randint(0, 2, 200)
    jm = jcpm.CpmModulator(shape, h=0.5, samples_per_sym=4, L=2, M=2)
    tm = tcpm.CpmModulator(shape, h=0.5, samples_per_sym=4, L=2, M=2,
                           device="cpu")
    y = tm.modulate(syms).numpy()
    np.testing.assert_allclose(y, np.asarray(jm.modulate(syms)), atol=1e-5)
    np.testing.assert_allclose(np.abs(y), 1.0, atol=1e-5)
    run = np.unwrap(np.angle(tm.modulate(np.ones(64, np.int32)).numpy()))
    per_sym = (run[-1] - run[16]) / ((len(run) - 17) / 4)
    np.testing.assert_allclose(per_sym, np.pi * 0.5, rtol=0.05)


def test_msk_equals_lrec1():
    """tests/test_apps.py:105-117: CPM(LREC, L=1, h=0.5) is MSK."""
    syms = np.random.RandomState(11).randint(0, 2, 100)
    y = tcpm.CpmModulator("LREC", h=0.5, samples_per_sym=8, L=1, M=2,
                          device="cpu").modulate(syms)
    fm = tdsp.quadrature_demod(torch.cat([torch.ones(1, dtype=torch.complex64),
                                          y]), 1.0).numpy()
    np.testing.assert_array_equal(fm[4::8][:100] > 0, syms.astype(bool))


# -------------------------------------------------------- modem registry
def test_modulation_registry():
    mods = tmu.type_1_mods()
    assert set(mods) == set(jmu.type_1_mods()) >= {"gmsk", "dbpsk", "4fsk"}
    assert set(tmu.type_1_demods()) == set(jmu.type_1_demods())
    assert mods["gmsk"] is tmodems.GmskModem

    class Opts:
        samples_per_symbol = 8
        bt = 0.4
        unrelated = "x"

    kw = tmu.extract_kwargs_from_options(mods["gmsk"], Opts())
    assert kw == {"samples_per_symbol": 8, "bt": 0.4}


# ------------------------------------------------------------------ BERT
def test_bert_transmit_bits_and_samples():
    """The scrambled all-ones stream and its samples, over two calls."""
    jt = jbert.BertTransmit(m=2, samples_per_symbol=4)
    tt = tbert.BertTransmit(m=2, samples_per_symbol=4, device="cpu")
    for n in (300, 500):
        np.testing.assert_array_equal(tt.bits(n), np.asarray(jt.bits(n)))
    np.testing.assert_allclose(tt.samples(256), np.asarray(jt.samples(256)),
                               atol=1e-5)


def test_bert_clean_loopback():
    """tests/test_apps.py:252-258 on a shorter stream: BER 0, the probes
    equal grtpu's (at 2^11 bits the acquisition transient weighs more in
    the SNR probe than at grtpu's 2^14: 21.7 dB against its gate of 25,
    which grtpu reads the same here)."""
    ber, rx = tbert.bert_loopback(nbits=1 << 11, m=2, sps=4, settle=512,
                                  device="cpu")
    jber, jrx = jbert.bert_loopback(nbits=1 << 11, m=2, sps=4, settle=512)
    assert ber == jber == 0.0
    assert abs(rx.snr() - jrx.snr()) < 0.01 and rx.snr() > 20.0
    assert rx.nbits == jrx.nbits
    assert abs(rx.density() - jrx.density()) < 1e-5
    assert abs(rx.frequency_offset() - jrx.frequency_offset()) < 1e-6


def test_bert_noisy_cfo_loopback():
    """tests/test_apps.py:260-271's gates (BER < 0.05, FLL offset within
    its bound, SNR probe sane) at 2^12 bits."""
    ber, rx = tbert.bert_loopback(nbits=1 << 12, m=2, sps=4, snr_db=10.0,
                                  cfo=0.002, settle=1024, device="cpu")
    assert ber < 0.05
    foff = rx.frequency_offset(sample_rate=1.0)
    assert abs(foff - (-0.002)) < 8e-4 or abs(foff) < 25e-4
    assert 5.0 < rx.snr() < 30.0


def test_bert_counts_descrambled_errors():
    """One flipped bit into the descrambler flips four of its outputs: its
    own and one at each of the CCSDS polynomial's three taps."""
    tx = tbert.BertTransmit(m=2, samples_per_symbol=4, device="cpu")
    b = tx.bits(1024)
    d = tlfsr.Descrambler(tbert.CCSDS_MASK, tbert.CCSDS_SEED, tbert.CCSDS_LEN)
    _, clean = d.apply(d.init_state(), t(b))
    assert (clean.numpy()[8:] == 1).all()     # synchronized after 8 bits
    b[600] ^= 1
    _, hit = d.apply(d.init_state(), t(b))
    assert np.nonzero((hit != clean).numpy())[0].tolist() == [600, 601, 605,
                                                             607]
