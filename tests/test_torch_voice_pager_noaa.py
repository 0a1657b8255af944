"""grtpu_torch.models.{digital_voice,pager,noaa} held against grtpu.

The NOAA deframer is held word-exact: to grtpu's 2-frame stream
(tests/test_noaa.py:47-66, 443,647 samples, whole and chunked), to a numpy
per-sample model of grtpu's state machine (noaa.py:158-206) at ragged chunks
with equal carried state after every chunk, and to grtpu itself on a short
stream.  ``HrptPll`` is held to grtpu and to the reference recurrence at
grtpu's 3e-5 (tests/test_noaa.py:113).  The pager's bit layer is a copy of
grtpu's numpy code (identical output); ``PagerSlicer`` carries the FLEX
numeric page of tests/test_pager_misc.py:197-234 in both run modes.
Digital voice (GSM over GMSK) is compared with grtpu's own round trip.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grtpu.models import noaa as jnoaa  # noqa: E402
from grtpu.models import pager as jpager  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu_torch.blocks import gengen as tgen  # noqa: E402
from grtpu_torch.models import noaa as tnoaa  # noqa: E402
from grtpu_torch.models import pager as tpager  # noqa: E402

MODES = ["eager", "device_loop"]
NW = tnoaa.HRPT_MINOR_FRAME_WORDS


# ------------------------------------------------------------ NOAA
def make_frame(rng, mfnum, addr=13, day=200, ms=12345678):
    w = rng.randint(0, 1024, NW).astype(np.int64)
    w[:6] = tnoaa.HRPT_SYNC_WORDS
    w[6] = (mfnum << 7) | (addr << 3) | (w[6] & 0x7)
    w[8] = (day << 1) | (w[8] & 1)
    w[9] = (w[9] & 0x380) | ((ms >> 20) & 0x7F)
    w[10] = (ms >> 10) & 0x3FF
    w[11] = ms & 0x3FF
    return w


def biphase(bits):
    out = np.empty(2 * len(bits), np.uint8)
    out[0::2] = 1 - bits
    out[1::2] = bits
    return out


def hrpt_stream(frames, rng, lead=37, tail=10):
    words = np.concatenate(frames)
    return words, np.concatenate([
        rng.randint(0, 2, lead).astype(np.uint8),
        biphase(tnoaa.encode_words(words)), np.zeros(tail, np.uint8)])


_SYNC = tnoaa._SYNC60


def deframer_model(x, st):
    """grtpu's HrptDeframer step (noaa.py:158-206), one sample at a time,
    in Python ints; returns (state', words)."""
    mid, last, synced, sh, word, bitc, wordc = (
        st["mid"], st["last"], st["synced"], st["sh"], st["word"],
        st["bitc"], st["wordc"])
    out = []
    ndata = NW - 6
    for v in x:
        bit = int(v) & 1
        proc = mid and ((bit ^ last) != 0 or synced)
        hit = False
        if proc and not synced:
            sh = ((sh << 1) | bit) & ((1 << 60) - 1)
            hit = sh == _SYNC
        if proc and synced:
            word = (word << 1) | bit
            if bitc == 1:
                out.append(word)
                word, bitc = 0, 10
                wordc -= 1
                if wordc == 0:
                    synced = False
            else:
                bitc -= 1
        if hit:
            out.extend(tnoaa.HRPT_SYNC_WORDS)
            synced, word, bitc, wordc = True, 0, 10, ndata
        mid = not proc
        last = bit
    return dict(mid=mid, last=last, synced=synced, sh=sh, word=word,
                bitc=bitc, wordc=wordc), out


def model_init():
    return dict(mid=True, last=0, synced=False, sh=0, word=0, bitc=0,
                wordc=0)


def state_as_ints(st):
    return {k: (bool(v) if v.dtype == torch.bool else int(v))
            for k, v in st.items()}


@pytest.fixture(scope="module")
def two_frames():
    rng = np.random.RandomState(7)
    return hrpt_stream([make_frame(rng, 1), make_frame(rng, 2)], rng)


def test_deframer_recovers_grtpus_two_frame_stream(two_frames):
    """tests/test_noaa.py:47-66's stream (443,647 samples), whole and in
    2^17 chunks, word for word; the whole-stream call within 10 s on the
    CPU."""
    words, stream = two_frames
    assert len(stream) == 443_647
    blk = tnoaa.HrptDeframer()
    t0 = time.perf_counter()
    _, (y, n) = blk.apply(blk.init_state(), torch.from_numpy(stream))
    assert time.perf_counter() - t0 < 10.0
    assert int(n) == 2 * NW
    np.testing.assert_array_equal(y[:int(n)].numpy().astype(np.int64)
                                  & 0x3FF, words)
    st, parts = blk.init_state(), []
    for i in range(0, len(stream), 1 << 17):
        st, (yc, nc) = blk.apply(st, torch.from_numpy(stream[i:i + (1 << 17)]))
        parts.append(yc[:int(nc)].numpy())
    np.testing.assert_array_equal(np.concatenate(parts).astype(np.int64)
                                  & 0x3FF, words)


@pytest.mark.parametrize("chunks", [
    [100_003, 7, 60_000, 123_457],      # sync and words split across chunks
    [5_000],                             # chunks far below a frame
    [221_689, 221_680],                  # a frame boundary near a chunk end
])
def test_deframer_equals_the_per_sample_model_at_ragged_chunks(two_frames,
                                                               chunks):
    """Lead-in noise, two back-to-back frames, a sync word split across
    chunks and chunks that end mid-word: equal words and equal carried
    state after every chunk."""
    words, stream = two_frames
    blk = tnoaa.HrptDeframer()
    st, mst = blk.init_state(), model_init()
    got, want, i, c = [], [], 0, 0
    while i < len(stream):
        size = chunks[c % len(chunks)]
        piece = stream[i:i + size]
        st, (y, n) = blk.apply(st, torch.from_numpy(piece))
        mst, w = deframer_model(piece, mst)
        got.extend(y[:int(n)].tolist())
        want.extend(w)
        assert state_as_ints(st) == mst, (i, size)
        i, c = i + size, c + 1
    assert got == want
    np.testing.assert_array_equal(np.asarray(got) & 0x3FF, words)


def test_deframer_equals_grtpu_on_a_short_stream(two_frames):
    """The first 6,037 samples of the 2-frame stream: the lead-in, the sync
    word and 300 words of the first frame."""
    stream = two_frames[1][:37 + 2 * 10 * 300]
    jb = jnoaa.HrptDeframer()
    jst, (jy, jn) = jb.apply(jb.init_state(), jnp.asarray(stream))
    tb = tnoaa.HrptDeframer()
    tst, (ty, tn) = tb.apply(tb.init_state(), torch.from_numpy(stream))
    assert int(tn) == int(jn) == 300
    np.testing.assert_array_equal(ty.numpy()[:int(tn)],
                                  np.asarray(jy)[:int(jn)])
    assert int(tst["sh"]) == (int(jst["hi"]) << 32) | int(jst["lo"])
    for k in ("word", "bitc", "wordc"):
        assert int(tst[k]) == int(jst[k]), k
    for k in ("mid", "synced"):
        assert bool(tst[k]) == bool(jst[k]), k
    assert int(tst["last"]) == int(jst["last"])


def _hrpt_graph(chunk):
    g = grtpu_torch.Graph()
    pin = g.add_input(grtpu_torch.Port(torch.uint8))
    dec = tnoaa.HrptDecoder()
    g.connect(pin, tnoaa.HrptDeframer(), dec)
    return grtpu_torch.StreamExecutor(g, chunk_size=chunk, device="cpu"), dec


@pytest.mark.parametrize("mode", MODES)
def test_deframer_and_decoder_in_the_executor(two_frames, mode):
    words, stream = two_frames
    # 22,180 samples a chunk: an emission of 1,109 words, so the two
    # frames' 22,180 words leave nothing queued in the FIFO at the end
    ex, dec = _hrpt_graph(22_180)
    ex.run(torch.from_numpy(stream), device_loop=mode == "device_loop")
    got = dec.captured[0].numpy().astype(np.int64) & 0x3FF
    np.testing.assert_array_equal(got, words)
    rep = dec.report()
    assert rep["frames_seen"] == 2 and rep["seq_errs"] == 0
    assert rep["mfnums"] == [1, 2] and rep["spacecraft"] == "NOAA18"


def test_decoder_report_equals_grtpu():
    rng = np.random.RandomState(5)
    for frames in ([make_frame(rng, 1, 13, 123, 4242424),
                    make_frame(rng, 2, 13, 123, 4242424)],
                   [make_frame(rng, 1), make_frame(rng, 3)]):
        data = np.concatenate(frames).astype(np.int16)
        t, j = tnoaa.HrptDecoder(), jnoaa.HrptDecoder()
        t.captured = (torch.from_numpy(data),)
        j.captured = (data,)
        assert t.report() == j.report()


def test_host_helpers_identical_to_grtpu():
    rng = np.random.RandomState(6)
    w = rng.randint(0, 1024, 500)
    np.testing.assert_array_equal(tnoaa.encode_words(w),
                                  jnoaa.encode_words(w))
    bits = tnoaa.encode_words(w)
    np.testing.assert_array_equal(tnoaa.decode_words(bits),
                                  jnoaa.decode_words(bits))
    np.testing.assert_array_equal(tnoaa.sync_bits(), jnoaa.sync_bits())
    frame = make_frame(rng, 2)
    stream = np.concatenate([rng.randint(0, 2, 29),
                             tnoaa.encode_words(frame), rng.randint(0, 2, 9)])
    a, b = tnoaa.deframe(stream), jnoaa.deframe(stream)
    assert len(a) == len(b) == 1
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("mode", MODES)
def test_hrpt_pll_against_grtpu_and_the_reference_recurrence(mode):
    """tests/test_noaa.py:91-113 at grtpu's 3e-5."""
    rng = np.random.RandomState(7)
    n, fo = 512, 0.02
    data = np.sign(rng.randn(n)).astype(np.float32)
    ph = np.cumsum(np.full(n, fo)) + 0.6 * data
    x = np.exp(1j * ph).astype(np.complex64)
    alpha, beta, moff = 0.05, 0.05 ** 2 / 4, 0.1
    g = grtpu_torch.Graph()
    pin = g.add_input(grtpu_torch.Port(torch.complex64))
    pout = g.add_output(grtpu_torch.Port(torch.float32))
    g.connect(pin, tnoaa.HrptPll(alpha=alpha, max_offset=moff), pout)
    y = grtpu_torch.StreamExecutor(g, chunk_size=200, device="cpu").run(
        torch.from_numpy(x), device_loop=mode == "device_loop").numpy()
    jb = jnoaa.HrptPll(alpha=alpha, max_offset=moff)
    _, jy = jb.apply(jb.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(jy), atol=3e-5)

    def wrap(p):
        return (p + np.pi) % (2 * np.pi) - np.pi

    phase = freq = 0.0
    ref = np.zeros(n, np.float32)
    for i, xi in enumerate(x):
        ref[i] = np.imag(xi * np.exp(-1j * phase))
        err = wrap(np.angle(xi) - phase)
        freq = np.clip(freq + beta * err, -moff, moff)
        phase = wrap(phase + alpha * err + freq)
    np.testing.assert_allclose(y, ref, atol=3e-5)


def test_hrpt_pll_tracks_and_demodulates():
    rng = np.random.RandomState(8)
    n = 4000
    data = np.sign(rng.randn(n)).astype(np.float32)
    ph = np.cumsum(np.full(n, 0.01)) + 0.7 * data
    x = np.exp(1j * ph).astype(np.complex64)
    blk = tnoaa.HrptPll(alpha=0.05)
    _, y = blk.apply(blk.init_state(), torch.from_numpy(x))
    assert (np.sign(y.numpy()[1000:]) == data[1000:]).mean() > 0.98


# ------------------------------------------------------------ pager
def test_pager_bit_layer_identical_to_grtpu():
    rng = np.random.RandomState(44)
    for _ in range(20):
        info = int(rng.randint(0, 1 << 21))
        cw = tpager._bch_encode_word(info)
        assert cw == jpager._bch_encode_word(info)
        assert tpager.flex_encode_word(info) == jpager.flex_encode_word(info)
        bad = cw ^ (1 << int(rng.randint(0, 31))) ^ (1 << 5)
        assert tpager.bch_decode_word(bad) == jpager.bch_decode_word(bad)
    words = rng.randint(0, 1 << 32, 8).astype(np.uint64)
    bits = tpager.flex_interleave(words)
    np.testing.assert_array_equal(bits, jpager.flex_interleave(words))
    np.testing.assert_array_equal(tpager.flex_deinterleave(bits), words)
    noisy = np.concatenate([rng.randint(0, 2, 37).astype(np.uint8),
                            np.array([(tpager.FLEX_SYNC_1600 >> (31 - i)) & 1
                                      for i in range(32)], np.uint8), bits])
    assert tpager.find_sync(noisy) == jpager.find_sync(noisy) == 69
    for msg in ("911", "555-1212"):
        assert tpager.pack_numeric(msg) == jpager.pack_numeric(msg)
    assert tpager.pack_alpha("HELLO") == jpager.pack_alpha("HELLO")
    garbage = list(rng.randint(0, 1 << 21, 88))
    assert tpager.parse_frame(garbage) == jpager.parse_frame(garbage)


def _flex_numeric_frame(msg):
    mwords = tpager.pack_numeric(msg)
    mw1 = 3
    viw = ((len(mwords) - 1) << 14) | (mw1 << 7) | \
        (tpager.FLEX_STANDARD_NUMERIC << 4)
    dw = [0x1FFFFF] * 88
    dw[0] = (2 << 10) | (0 << 8)
    dw[1] = 20000 + 0x8000
    dw[2] = viw
    for k, w in enumerate(mwords):
        dw[mw1 + k] = w
    return dw


@pytest.mark.parametrize("mode", MODES)
def test_numeric_page_through_the_slicer(mode):
    """tests/test_pager_misc.py:197-234 with the port's slicer."""
    msg = "555-8712"
    frame = _flex_numeric_frame(msg)
    coded = np.array([tpager.flex_encode_word(w) for w in frame[:8]],
                     np.uint64)
    bits = np.concatenate([
        np.array([(tpager.FLEX_SYNC_1600 >> (31 - i)) & 1
                  for i in range(32)], np.uint8),
        tpager.flex_interleave(coded)])
    bb = bits.astype(np.float32) * 2 - 1
    g = grtpu_torch.Graph()
    pin = g.add_input(grtpu_torch.Port(torch.float32))
    sink = tgen.VectorSink(torch.uint8)
    g.connect(pin, tpager.PagerSlicer(), sink)
    grtpu_torch.StreamExecutor(g, chunk_size=100, device="cpu").run(
        torch.from_numpy(bb), device_loop=mode == "device_loop")
    rx_bits = (sink.data() >> 1).astype(np.uint8)
    start = tpager.find_sync(rx_bits)
    assert start == 32
    infos = []
    for w in tpager.flex_deinterleave(rx_bits[start:start + 256]):
        info, _ = tpager.flex_decode_word(int(w))
        assert info is not None
        infos.append(info)
    pages = tpager.parse_frame(infos + frame[8:])
    assert len(pages) == 1 and pages[0]["content"] == msg


def test_slicer_levels_equal_grtpu():
    x = np.array([1.0, 0.33, -0.33, -1.0, 2 / 3, -2 / 3, 0.0, 0.7],
                 np.float32)
    blk, jblk = tpager.PagerSlicer(), jpager.PagerSlicer()
    _, y = blk.apply((), torch.from_numpy(x))
    _, jy = jblk.apply((), jnp.asarray(x))
    assert y.dtype == torch.uint8
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert y[:4].tolist() == [0b10, 0b11, 0b01, 0b00]


# ------------------------------------------------------------ digital voice
def test_digital_voice_roundtrip_against_grtpu():
    """tests/test_vocoder_gsm.py:65-79: audio -> GSM -> GMSK -> back; the
    transmitted baseband and the decoded audio against grtpu's."""
    from grtpu.models.digital_voice import (DigitalVoiceRx as JRx,
                                            DigitalVoiceTx as JTx)
    from grtpu_torch.models.digital_voice import DigitalVoiceRx, DigitalVoiceTx

    t = np.arange(160 * 8)
    audio = (0.5 * np.sin(2 * np.pi * 300 / 8000 * t)
             + 0.2 * np.sin(2 * np.pi * 1100 / 8000 * t)).astype(np.float32)
    tx, rx = DigitalVoiceTx(device="cpu"), DigitalVoiceRx(device="cpu")
    iq = tx(audio)
    jiq = np.asarray(JTx()(audio))
    np.testing.assert_allclose(iq.numpy(), jiq, atol=2e-4)
    out = rx(iq.numpy())
    jout = np.asarray(JRx()(jiq))
    assert out.shape == jout.shape
    n = min(len(out), len(audio))
    a = audio[:n] - audio[:n].mean()
    b = out[:n] - out[:n].mean()
    assert np.corrcoef(a[320:], b[320:])[0, 1] > 0.9
    np.testing.assert_array_equal(out, jout)
