"""grtpu_torch's modems, constellations and DMR burst layer held against
grtpu's on the CPU.

Same numpy inputs (local RandomState seeds) through both packages:
interp_fir_filter to 1e-5 of max|grtpu|; constellation decisions exactly;
modulators to atol 1e-4 (the FM phase is a cumsum, which torch sums in
float64 on a CPU); demodulators fed grtpu's own modulated samples give
identical dibits/bits; the burst bank's pre-slicer levels agree to atol
1e-4; DMR payloads are identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grtpu.digital import constellation as jc  # noqa: E402
from grtpu.digital import modems as jm  # noqa: E402
from grtpu.models import dmr as jdmr  # noqa: E402
from grtpu.ops import fir as jfir  # noqa: E402
from grtpu_torch.digital import constellation as tc  # noqa: E402
from grtpu_torch.digital import modems as tm  # noqa: E402
from grtpu_torch.models import dmr as tdmr  # noqa: E402
from grtpu_torch.ops import fir as tfir  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("interp,k,n,cplx", [(2, 9, 100, False),
                                             (3, 40, 333, True),
                                             (10, 110, 50, False),
                                             (4, 16, 1000, True)])
def test_interp_fir_filter(interp, k, n, cplx):
    rng = np.random.RandomState(k)
    taps = rng.randn(k).astype(np.float32)
    kp = -(-k // interp)
    x = rng.randn(n + kp - 1).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.randn(n + kp - 1)).astype(np.complex64)
    ref = np.asarray(jfir.interp_fir_filter(jnp.asarray(x), jnp.asarray(taps),
                                            interp))
    got = tfir.interp_fir_filter(t(x), taps, interp)
    assert got.dtype == (torch.complex64 if cplx else torch.float32)
    assert rel(got.numpy(), ref) < 1e-5
    up = np.zeros((n + kp - 1) * interp, x.dtype)
    up[::interp] = x
    full = np.convolve(up, taps)[(kp - 1) * interp:(kp - 1) * interp + n * interp]
    assert rel(got.numpy(), full) < 1e-5


@pytest.mark.parametrize("make", ["constellation_bpsk", "constellation_qpsk",
                                  "constellation_dqpsk", "constellation_8psk",
                                  "psk4", "qam16"])
def test_constellation_decisions(make):
    def build(mod):
        if make == "psk4":
            return mod.psk_constellation(4)
        if make == "qam16":
            return mod.qam_constellation(16)
        return getattr(mod, make)()

    cj, ct = build(jc), build(tc)
    np.testing.assert_array_equal(ct.points, cj.points)
    assert (ct.rotational_symmetry, ct.bits_per_symbol()) == (
        cj.rotational_symmetry, cj.bits_per_symbol())
    rng = np.random.RandomState(3)
    x = (cj.points[rng.randint(0, cj.arity(), 500)]
         + 0.3 * (rng.randn(500) + 1j * rng.randn(500))).astype(np.complex64)
    dj = np.asarray(cj.decision_maker(jnp.asarray(x)))
    dt = ct.decision_maker(t(x))
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_allclose(ct.soft_decision_maker(t(x), 0.5).numpy(),
                               np.asarray(cj.soft_decision_maker(x, 0.5)),
                               atol=1e-5)
    np.testing.assert_allclose(ct.phase_error(t(x)).numpy(),
                               np.asarray(cj.phase_error(jnp.asarray(x))),
                               atol=1e-5)
    np.testing.assert_array_equal(ct.map_to_points(t(dj)).numpy(),
                                  np.asarray(cj.map_to_points(dj)))


def test_fsk4_symbols_and_bits():
    np.testing.assert_array_equal(tc.fsk4_symbols(1944.0),
                                  jc.fsk4_symbols(1944.0))
    data = np.arange(17, dtype=np.uint8) * 15
    for k in (1, 2, 3):
        np.testing.assert_array_equal(tm._bits_msb(data[:15], k),
                                      jm._bits_msb(data[:15], k))


def modem_pair(kind, **kw):
    cls = {"fsk4": "Fsk4Modem", "gmsk": "GmskModem", "psk": "PskModem"}[kind]
    return getattr(jm, cls)(**kw), getattr(tm, cls)(**kw, device="cpu")


@pytest.mark.parametrize("kind,kw,nsym", [
    ("fsk4", {"samples_per_symbol": 10}, 300),
    ("gmsk", {"samples_per_symbol": 4}, 400),
    ("psk", {"m": 2, "samples_per_symbol": 4}, 400),
    ("psk", {"m": 8, "samples_per_symbol": 4}, 402),
])
def test_modulate(kind, kw, nsym):
    mj, mt = modem_pair(kind, **kw)
    rng = np.random.RandomState(5)
    data = (rng.randint(0, 4, nsym) if kind == "fsk4"
            else rng.randint(0, 2, nsym)).astype(np.uint8)
    yj = np.asarray(mj.modulate(data))
    yt = mt.modulate(data)
    assert yt.dtype == torch.complex64 and yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-4)


@pytest.mark.parametrize("kind,kw,nsym", [
    ("fsk4", {"samples_per_symbol": 5}, 600),
    ("fsk4", {"samples_per_symbol": 5, "chunked": True}, 600),
    ("gmsk", {"samples_per_symbol": 4}, 600),
    ("psk", {"m": 4, "samples_per_symbol": 4}, 500),
])
def test_demodulate_grtpu_samples(kind, kw, nsym):
    """Fed grtpu's own modulated, noisy samples, the port decides the same
    dibits/bits."""
    mj, mt = modem_pair(kind, **kw)
    rng = np.random.RandomState(6)
    data = (rng.randint(0, 4, nsym) if kind == "fsk4"
            else rng.randint(0, 2, nsym)).astype(np.uint8)
    x = jm.awgn(np.asarray(mj.modulate(data)), 15.0, seed=2)
    np.testing.assert_array_equal(tm.awgn(x, 15.0, seed=2),
                                  jm.awgn(x, 15.0, seed=2))
    dj = mj.demodulate(x)
    dt = mt.demodulate(x)
    assert dt.dtype == np.uint8 and dt.shape == dj.shape
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("n", [1000, 1001, 2 * 8192 + 6])
def test_median_semantics(n):
    """jnp.median's even-count mean of the two middles, not torch.median's
    lower middle."""
    x = np.random.RandomState(n).randn(3, n).astype(np.float32)
    np.testing.assert_array_equal(
        tm.median_lastdim(t(x)).numpy(),
        np.asarray(jnp.median(jnp.asarray(x), axis=1, keepdims=True)))


def test_burst_bank_levels():
    """C x N bank with N even and below 8192 * 2, so the median subsample
    (stride 1) has an even count."""
    mj, mt = modem_pair("fsk4", samples_per_symbol=10)
    rng = np.random.RandomState(4)
    C, nsym = 3, 150
    bursts = []
    for c in range(C):
        iq = np.asarray(mj.modulate(rng.randint(0, 4, nsym)))
        iq = iq * np.exp(1j * 2 * np.pi * (20 * c - 20) / 48000
                         * np.arange(len(iq)))
        bursts.append(jm.awgn(iq, 20.0, seed=c))
    x = np.stack(bursts)
    assert x.shape[1] % 2 == 0 and x.shape[1] // 8192 <= 1
    lj = np.asarray(mj._burst_bank_fn(jnp.asarray(x)))
    lt = mt._burst_bank_fn(t(x))
    assert lt.shape == lj.shape == (C, nsym)
    np.testing.assert_allclose(lt.numpy(), lj, atol=1e-4)
    np.testing.assert_array_equal(mt.demodulate_burst_bank(x),
                                  mj.demodulate_burst_bank(x))
    for c in range(C):
        np.testing.assert_array_equal(mt.demodulate_burst(x[c]),
                                      mj.demodulate_burst(x[c]))


class TestDmrBurst:
    """tests/test_digital.py's TestDmrBurst, through both packages: the same
    samples give the same payloads, and the port's own transmitter round
    trips."""

    def _pair(self):
        return ((jdmr.DmrTransmitter(10), jdmr.DmrReceiver(10)),
                (tdmr.DmrTransmitter(10, device="cpu"),
                 tdmr.DmrReceiver(10, device="cpu")))

    def test_burst_roundtrip_clean(self):
        (txj, rxj), (txt, rxt) = self._pair()
        payload = np.random.RandomState(21).randint(0, 2, 216).astype(np.uint8)
        sj = np.asarray(txj.transmit(payload, "bs_data"))
        st = txt.transmit(payload, "bs_data")
        np.testing.assert_allclose(st.numpy(), sj, atol=1e-4)
        got = rxt.receive(sj, "bs_data")
        want = rxj.receive(sj, "bs_data")
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], payload)
        own = rxt.receive(st, "bs_data")
        assert len(own) == 1
        np.testing.assert_array_equal(own[0], payload)

    def test_burst_with_noise_and_cfo(self):
        (txj, rxj), (_, rxt) = self._pair()
        payload = np.random.RandomState(22).randint(0, 2, 216).astype(np.uint8)
        s = np.asarray(txj.transmit(payload, "bs_voice"))
        s = s * np.exp(1j * 2 * np.pi * 50 / 48000 * np.arange(len(s)))
        noisy = jm.awgn(s, 15.0, seed=4)
        got = rxt.receive(noisy, "bs_voice")
        want = rxj.receive(noisy, "bs_voice")
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[0] != payload).mean() < 0.02

    def test_wrong_sync_rejected(self):
        (txj, rxj), (_, rxt) = self._pair()
        payload = np.random.RandomState(23).randint(0, 2, 216).astype(np.uint8)
        samples = np.asarray(txj.transmit(payload, "bs_data"))
        assert rxt.receive(samples, "ms_voice", max_errors=2) == []
        assert rxj.receive(samples, "ms_voice", max_errors=2) == []


def test_burst_helpers_identical():
    rng = np.random.RandomState(24)
    p = rng.randint(0, 2, 216).astype(np.uint8)
    for sync in tdmr.SYNC_PATTERNS:
        np.testing.assert_array_equal(tdmr.make_burst(p, sync),
                                      jdmr.make_burst(p, sync))
        np.testing.assert_array_equal(
            tdmr.sync_dibits(tdmr.SYNC_PATTERNS[sync]),
            jdmr.sync_dibits(jdmr.SYNC_PATTERNS[sync]))
    d = tdmr.bits_to_dibits(np.concatenate([tdmr.make_burst(p), p[:40]]))
    assert tdmr.find_bursts(d) == jdmr.find_bursts(d) == [0]
    np.testing.assert_array_equal(tdmr.extract_payload(d, 0), p)
    assert tdmr.extract_payload(d, 100) is None
