"""grtpu_torch.vocoder held against grtpu.vocoder and the reference goldens.

Every integer codec is bit-exact: against tests/data/vocoder_golden.npz
(read by path) and against grtpu on the same numpy input, in both
directions.  A whole golden stream is run as a bank of channels, each lane
started from grtpu's carried state at its boundary; so every sample of the
stream is held to the golden, the bank to single-channel grtpu runs, and
each lane's final state to grtpu's state at the next boundary.  Blocks run
through the port's executor at ragged chunks, eagerly and under
``run(device_loop=True)`` (on the CPU the static-buffer step without a
graph), against the whole-stream call.  Codec2 keeps grtpu's gates
(tests/test_vocoder_codec2.py) and refuses ``device_loop``.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grtpu.vocoder import codec2 as jc2  # noqa: E402
from grtpu.vocoder import cvsd as jcvsd  # noqa: E402
from grtpu.vocoder import g711 as jg711  # noqa: E402
from grtpu.vocoder import g72x as jg72x  # noqa: E402
from grtpu.vocoder import gsm as jgsm  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu_torch import vocoder as tvoc  # noqa: E402
from grtpu_torch.vocoder import codec2 as tc2  # noqa: E402
from grtpu_torch.vocoder import cvsd as tcvsd  # noqa: E402
from grtpu_torch.vocoder import g711 as tg711  # noqa: E402
from grtpu_torch.vocoder import g72x as tg72x  # noqa: E402
from grtpu_torch.vocoder import gsm as tgsm  # noqa: E402

HERE = os.path.dirname(__file__)
GOLD = np.load(os.path.join(HERE, "data", "vocoder_golden.npz"))
VARIANTS = ["g721", "g723_24", "g723_40"]
MODES = ["eager", "device_loop"]


def T(a):
    return torch.from_numpy(np.array(a))


def chain_run(block, x, chunk, mode, out_vlen=1):
    """input pad -> block -> output pad on the CPU; returns numpy."""
    g = grtpu_torch.Graph()
    ip, op = block.in_ports[0], block.out_ports[0]
    pin = g.add_input(grtpu_torch.Port(ip.dtype, ip.vlen))
    pout = g.add_output(grtpu_torch.Port(op.dtype, op.vlen))
    g.connect(pin, block, pout)
    ex = grtpu_torch.StreamExecutor(g, chunk_size=chunk, device="cpu")
    return ex.run(T(x), device_loop=mode == "device_loop").numpy()


# ---------------------------------------------------------------- G.711
@pytest.mark.parametrize("name,src,gold", [
    ("linear_to_alaw", np.arange(-32768, 32768, dtype=np.int16), "alaw_enc"),
    ("linear_to_ulaw", np.arange(-32768, 32768, dtype=np.int16), "ulaw_enc"),
    ("alaw_to_linear", np.arange(256, dtype=np.uint8), "alaw_dec"),
    ("ulaw_to_linear", np.arange(256, dtype=np.uint8), "ulaw_dec")])
def test_g711_exhaustive_against_golden_and_grtpu(name, src, gold):
    got = getattr(tg711, name)(T(src)).numpy()
    np.testing.assert_array_equal(got, GOLD[gold])
    np.testing.assert_array_equal(
        got, np.asarray(getattr(jg711, name)(jnp.asarray(src))))


@pytest.mark.parametrize("name", ["alaw_to_ulaw", "ulaw_to_alaw"])
def test_g711_transcode_equals_grtpu(name):
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        getattr(tg711, name)(T(codes)).numpy(),
        np.asarray(getattr(jg711, name)(jnp.asarray(codes))))


@pytest.mark.parametrize("mode", MODES)
def test_g711_blocks_roundtrip_fixed_point(mode):
    for enc, dec in [(tvoc.AlawEncode, tvoc.AlawDecode),
                     (tvoc.UlawEncode, tvoc.UlawDecode)]:
        codes = np.arange(256, dtype=np.uint8)
        pcm = chain_run(dec(), codes, 96, mode)
        again = chain_run(enc(), pcm, 96, mode)
        np.testing.assert_array_equal(chain_run(dec(), again, 96, mode), pcm)


# ---------------------------------------------------------------- G.72x
LANES = 8


def _jstate_to_torch(st):
    return tg72x.G72xState(*[T(np.asarray(leaf)) for leaf in st])


def _stack(states):
    return type(states[0])(*[torch.stack(leaves) for leaves in zip(*states)])


@pytest.fixture(scope="module")
def g72x_lanes():
    """grtpu's state at every 1000-sample boundary of the golden streams,
    for encode (input) and decode (its codes), each variant."""
    out = {}
    for v in VARIANTS:
        for direction, fn, src in (
                ("enc", jg72x.g72x_encode, GOLD["input"]),
                ("dec", jg72x.g72x_decode, GOLD[f"{v}_codes"])):
            st, states = jg72x.g72x_init_state(), []
            for lane in range(LANES):
                states.append(_jstate_to_torch(st))
                st, _ = fn(v, st, jnp.asarray(src[lane * 1000:
                                                  (lane + 1) * 1000]))
            states.append(_jstate_to_torch(st))
            out[v, direction] = states
    return out


@pytest.mark.parametrize("direction", ["enc", "dec"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_g72x_golden_stream_as_a_bank(g72x_lanes, variant, direction):
    states = g72x_lanes[variant, direction]
    if direction == "enc":
        src, gold, fn = GOLD["input"], GOLD[f"{variant}_codes"], \
            tg72x.g72x_encode
    else:
        src, gold, fn = GOLD[f"{variant}_codes"], GOLD[f"{variant}_dec"], \
            tg72x.g72x_decode
    fin, out = fn(variant, _stack(states[:LANES]),
                  T(src.reshape(LANES, 1000)))
    assert out.shape == (LANES, 1000)
    np.testing.assert_array_equal(out.numpy().reshape(-1), gold)
    want = _stack(states[1:])
    for name, a, b in zip(tg72x.G72xState._fields, fin, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("variant", VARIANTS)
def test_g72x_single_channel_from_init_equals_grtpu(variant):
    x = GOLD["input"][:300]
    st, codes = tg72x.g72x_encode(
        variant, tg72x.g72x_init_state(device="cpu"), T(x))
    jst, jcodes = jg72x.g72x_encode(variant, jg72x.g72x_init_state(),
                                    jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, pcm = tg72x.g72x_decode(
        variant, tg72x.g72x_init_state(device="cpu"), codes)
    _, jpcm = jg72x.g72x_decode(variant, jg72x.g72x_init_state(), jcodes)
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(jpcm))


@pytest.mark.parametrize("mode", MODES)
def test_g721_blocks_ragged_chunks_equal_the_whole_call(mode):
    x = GOLD["input"][2000:2600]
    whole = tg72x.g72x_encode(
        "g721", tg72x.g72x_init_state(device="cpu"), T(x))[1].numpy()
    codes = chain_run(tvoc.G721Encode(), x, 256, mode)
    np.testing.assert_array_equal(codes, whole)
    pcm = chain_run(tvoc.G721Decode(), codes, 160, mode)
    np.testing.assert_array_equal(
        pcm, tg72x.g72x_decode("g721", tg72x.g72x_init_state(device="cpu"),
                               T(codes))[1].numpy())


def test_g72x_unroll_does_not_change_the_result(monkeypatch):
    """step_scan's static-buffer path (U steps a StepGraph call, the tail
    one by one) against the plain loop it takes below 2U steps."""
    from grtpu_torch.runtime import step_graph

    x = T(GOLD["input"][:90].reshape(2, 45))
    st0 = tg72x.g72x_init_state(channels=2, device="cpu")
    outs = []
    for u in (8, 16, 45):
        monkeypatch.setattr(step_graph, "UNROLL", u)
        outs.append(tg72x.g72x_encode("g723_40", st0, x))
    for st, y in outs[:2]:
        assert torch.equal(y, outs[2][1])
        assert all(torch.equal(p, q) for p, q in zip(st, outs[2][0]))


# ---------------------------------------------------------------- CVSD
def _cvsd_models():
    import sys
    sys.path.insert(0, HERE)
    from test_vocoder import _cvsd_decode_scalar, _cvsd_encode_scalar
    return _cvsd_encode_scalar, _cvsd_decode_scalar


def test_cvsd_against_the_scalar_models_and_grtpu():
    enc_model, dec_model = _cvsd_models()
    pcm = GOLD["input"][:2048].astype(np.int16)
    enc = tvoc.CvsdEncode()
    _, packed = enc.apply(enc.init_state(), T(pcm))
    np.testing.assert_array_equal(np.unpackbits(packed.numpy()),
                                  enc_model(pcm, enc.params))
    jenc = jcvsd.CvsdEncode()
    _, jpacked = jenc.apply(jenc.init_state(), jnp.asarray(pcm))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    dec = tvoc.CvsdDecode()
    st, got = dec.apply(dec.init_state(), packed)
    np.testing.assert_array_equal(got.numpy(),
                                  dec_model(packed.numpy(), dec.params))
    jdec = jcvsd.CvsdDecode()
    jst, jgot = jdec.apply(jdec.init_state(), jpacked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    for a, b in zip(st, jst):
        assert int(a) == int(b)


def test_cvsd_bank_equals_single_channels():
    p = tcvsd._CvsdParams()
    x = GOLD["input"][:1200].astype(np.int16).reshape(3, 400)
    st, bits = tcvsd.cvsd_encode_bits(
        p, tcvsd.cvsd_init_state(p, channels=3, device="cpu"), T(x))
    for c in range(3):
        s1, b1 = tcvsd.cvsd_encode_bits(
            p, tcvsd.cvsd_init_state(p, device="cpu"), T(x[c]))
        assert torch.equal(bits[c], b1)
        assert all(int(a[c]) == int(b) for a, b in zip(st, s1))
    jst, jbits = jcvsd.cvsd_encode_bits(jcvsd._CvsdParams(),
                                        jcvsd.cvsd_init_state(
                                            jcvsd._CvsdParams()),
                                        jnp.asarray(x[2]))
    np.testing.assert_array_equal(bits[2].numpy(), np.asarray(jbits))


@pytest.mark.parametrize("mode", MODES)
def test_cvsd_blocks_ragged_chunks_equal_the_whole_call(mode):
    pcm = GOLD["input"][:1000].astype(np.int16)
    enc = tvoc.CvsdEncode()
    _, whole = enc.apply(enc.init_state(), T(pcm))
    got = chain_run(tvoc.CvsdEncode(), pcm, 264, mode)
    np.testing.assert_array_equal(got, whole.numpy())
    dec = tvoc.CvsdDecode()
    _, wdec = dec.apply(dec.init_state(), whole)
    np.testing.assert_array_equal(
        chain_run(tvoc.CvsdDecode(), got, 48, mode), wdec.numpy())


def test_cvsd_hier_blocks_equal_grtpu():
    import grtpu

    t = np.arange(256)
    audio = (0.5 * np.sin(2 * np.pi * t / 40)).astype(np.float32)

    def run(pkg, blk, x, f32, u8):
        g = pkg.Graph()
        pin = g.add_input(pkg.Port(f32 if blk.__class__.__name__
                                   .endswith("FB") else u8))
        pout = g.add_output(pkg.Port(u8 if blk.__class__.__name__
                                     .endswith("FB") else f32))
        g.connect(pin, blk, pout)
        kw = {"device": "cpu"} if pkg is grtpu_torch else {"donate": False}
        y = pkg.StreamExecutor(g, chunk_size=64, **kw).run(x)
        return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)

    bits = run(grtpu_torch, tcvsd.CvsdEncodeFB(), T(audio), torch.float32,
               torch.uint8)
    jbits = run(grtpu, jcvsd.CvsdEncodeFB(), jnp.asarray(audio),
                jnp.float32, jnp.uint8)
    np.testing.assert_array_equal(bits, jbits)
    back = run(grtpu_torch, tcvsd.CvsdDecodeBF(), T(bits), torch.float32,
               torch.uint8)
    jback = run(grtpu, jcvsd.CvsdDecodeBF(), jnp.asarray(jbits),
                jnp.float32, jnp.uint8)
    np.testing.assert_allclose(back, jback, atol=1e-6)


# ---------------------------------------------------------------- GSM
GSM_LANES, GSM_FRAMES = 5, 10


def _jtree(st):
    return {k: T(np.asarray(v)) for k, v in st.items()}


def _stack_dict(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


@pytest.fixture(scope="module")
def gsm_lanes():
    """grtpu's encoder and decoder states at every 10-frame boundary of the
    golden stream."""
    n = 160 * GSM_FRAMES
    enc, dec = [], []
    st = jgsm.gsm_init_encode_state()
    ds = jgsm.gsm_init_decode_state()
    frames = GOLD["gsm_frames"].reshape(-1, 33)
    for lane in range(GSM_LANES):
        enc.append(_jtree(st))
        dec.append(_jtree(ds))
        st, _ = jgsm.gsm_fr_encode(st, jnp.asarray(
            GOLD["input"][lane * n:(lane + 1) * n].astype(np.int16)))
        ds, _ = jgsm.gsm_fr_decode(ds, jnp.asarray(
            frames[lane * GSM_FRAMES:(lane + 1) * GSM_FRAMES]))
    enc.append(_jtree(st))
    dec.append(_jtree(ds))
    return enc, dec


def test_gsm_encode_golden_stream_as_a_bank(gsm_lanes):
    enc, _ = gsm_lanes
    pcm = GOLD["input"].astype(np.int16).reshape(GSM_LANES, -1)
    fin, frames = tgsm.gsm_fr_encode(_stack_dict(enc[:-1]), T(pcm))
    assert frames.shape == (GSM_LANES, GSM_FRAMES, 33)
    np.testing.assert_array_equal(frames.numpy().reshape(-1),
                                  GOLD["gsm_frames"])
    want = _stack_dict(enc[1:])
    for k in want:
        assert torch.equal(fin[k], want[k]), k


def test_gsm_decode_golden_stream_as_a_bank(gsm_lanes):
    _, dec = gsm_lanes
    frames = GOLD["gsm_frames"].reshape(GSM_LANES, GSM_FRAMES, 33)
    fin, pcm = tgsm.gsm_fr_decode(_stack_dict(dec[:-1]), T(frames))
    assert pcm.shape == (GSM_LANES, 160 * GSM_FRAMES)
    np.testing.assert_array_equal(pcm.numpy().reshape(-1), GOLD["gsm_dec"])
    want = _stack_dict(dec[1:])
    for k in want:
        assert torch.equal(fin[k], want[k]), k


def test_gsm_pack_unpack_roundtrip_and_grtpu():
    rng = np.random.default_rng(7)
    params = rng.integers(0, 2 ** tgsm._WIDTHS, size=(5, 76)).astype(np.int32)
    frames = tgsm.gsm_pack(T(params))
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(jgsm.gsm_pack(jnp.asarray(params))))
    np.testing.assert_array_equal(tgsm.gsm_unpack(frames).numpy(), params)
    assert np.all((frames.numpy()[:, 0] >> 4) == 0xD)


@pytest.mark.parametrize("mode", MODES)
def test_gsm_blocks_ragged_chunks_equal_the_whole_call(mode):
    pcm = GOLD["input"][:160 * 5].astype(np.int16)
    _, whole = tgsm.gsm_fr_encode(tgsm.gsm_init_encode_state(device="cpu"),
                                  T(pcm))
    got = chain_run(tvoc.GsmFrEncode(), pcm, 320, mode)
    np.testing.assert_array_equal(got, whole.numpy())
    _, wdec = tgsm.gsm_fr_decode(tgsm.gsm_init_decode_state(device="cpu"),
                                 whole)
    np.testing.assert_array_equal(
        chain_run(tvoc.GsmFrDecode(), got, 2, mode), wdec.numpy())


def test_gsm_bank_equals_single_channels():
    x = GOLD["input"][:160 * 3].astype(np.int16)
    xs = np.stack([x, x[::-1].copy()])
    st, frames = tgsm.gsm_fr_encode(
        tgsm.gsm_init_encode_state(channels=2, device="cpu"), T(xs))
    _, one = tgsm.gsm_fr_encode(tgsm.gsm_init_encode_state(device="cpu"),
                                T(xs[1]))
    assert torch.equal(frames[1], one)
    _, jone = jgsm.gsm_fr_encode(jgsm.gsm_init_encode_state(),
                                 jnp.asarray(xs[1]))
    np.testing.assert_array_equal(one.numpy(), np.asarray(jone))


# ---------------------------------------------------------------- Codec2
def test_codec2_data_file_is_a_byte_identical_copy():
    import grtpu.vocoder as jv

    assert filecmp.cmp(os.path.join(os.path.dirname(jv.__file__),
                                    "data_codec2.npz"),
                       os.path.join(os.path.dirname(tvoc.__file__),
                                    "data_codec2.npz"), shallow=False)
    assert tc2._D is not jc2._D
    assert os.path.dirname(tc2.__file__) == os.path.dirname(tvoc.__file__)


def test_codec2_encode_byte_exact_and_equal_to_grtpu():
    bits = tc2.Codec2().encode(GOLD["input"])
    np.testing.assert_array_equal(np.asarray(bits, np.uint8),
                                  np.asarray(GOLD["c2_bits"], np.uint8))
    np.testing.assert_array_equal(
        tc2.Codec2().encode(GOLD["input"][:1600]),
        jc2.Codec2().encode(GOLD["input"][:1600]))


def test_codec2_decode_gates_of_grtpu():
    """tests/test_vocoder_codec2.py:46-60's gates, and grtpu's samples."""
    dec = tc2.Codec2().decode(GOLD["c2_bits"]).astype(np.int64)
    ref = GOLD["c2_dec"].astype(np.int64)
    n = min(len(dec), len(ref))
    err = (dec[:n] - ref[:n]).astype(np.float64)
    snr = 10 * np.log10((ref[:n].astype(np.float64) ** 2).mean()
                        / max((err ** 2).mean(), 1e-12))
    assert snr > 50.0, snr
    assert np.abs(err).max() < 64
    assert (np.abs(err) <= 1).mean() > 0.6
    np.testing.assert_array_equal(
        tc2.Codec2().decode(GOLD["c2_bits"][:70]),
        jc2.Codec2().decode(GOLD["c2_bits"][:70]))


def test_codec2_blocks_eager_copy_through_the_host():
    pcm = GOLD["input"][:1600].astype(np.int16)
    frames = chain_run(tvoc.Codec2Encode(), pcm, 480, "eager")
    assert frames.shape == (10, 7) and frames.dtype == np.uint8
    np.testing.assert_array_equal(
        frames.reshape(-1), tc2.Codec2().encode(pcm).reshape(-1))
    out = chain_run(tvoc.Codec2Decode(), frames, 4, "eager")
    assert out.shape == (1600,) and out.dtype == np.int16
    np.testing.assert_array_equal(out, tc2.Codec2().decode(frames))


@pytest.mark.parametrize("blk", ["Codec2Encode", "Codec2Decode"])
def test_codec2_blocks_refuse_device_loop(blk):
    block = getattr(tvoc, blk)(name="c2blk")
    if blk == "Codec2Encode":
        x = GOLD["input"][:320].astype(np.int16)
    else:
        x = np.zeros((2, 7), np.uint8)
    with pytest.raises(ValueError, match=r"device_loop: c2blk \(" + blk):
        chain_run(block, x, len(x), "device_loop")
    # the eager run of the same block still works afterwards
    assert chain_run(block, x, len(x), "eager").shape[0] > 0
