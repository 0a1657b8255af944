"""The vocoders, the rest of the block library and the NOAA deframer on the
card.

Held bit for bit against the CPU and the reference goldens: every integer
codec (G.711, G.721/G.723, CVSD, GSM 06.10) on a bank of channels equal to
the same bank on the CPU, with step_scan's CUDA graphs (U = 8, 16, 32) and
without; channel 0 carrying tests/data/vocoder_golden.npz's input (read by
path) gives its codes and frames; the blocks eager and under
``run(device_loop=True)`` ``torch.equal``; ``DpllBB`` and ``Threshold``
equal to the CPU, ``IqComp`` and ``HrptPll`` within grtpu's 1e-5 and
3e-5; BurstTagger's tags equal in both modes and on the CPU; the HRPT
deframer's words and carried state equal to the CPU at ragged chunks;
Codec2's blocks refused by ``device_loop``.  Every test needs an NVIDIA
GPU (marker ``cuda``) and skips elsewhere.  The file imports no JAX; from
the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_voice.py -m cuda --noconftest
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks import gengen, misc  # noqa: E402
from grtpu_torch.models import noaa  # noqa: E402
from grtpu_torch.runtime import step_graph  # noqa: E402
from grtpu_torch.vocoder import codec2, cvsd, g711, g72x, gsm  # noqa: E402

pytestmark = pytest.mark.cuda
GOLD = np.load(Path(__file__).resolve().parent / "data"
               / "vocoder_golden.npz")
MODES = ["eager", "device_loop"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bank(n, ch=4, seed=0):
    pcm = (np.random.RandomState(seed).randn(ch, n) * 3000).clip(
        -32768, 32767).astype(np.int16)
    pcm[0] = GOLD["input"][:n]
    return pcm


def tree_equal(a, b):
    if isinstance(a, dict):
        return all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(tree_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("name", ["linear_to_alaw", "linear_to_ulaw"])
def test_g711_exhaustive(dev, name):
    pcm = torch.arange(-32768, 32768, dtype=torch.int16)
    got = getattr(g711, name)(pcm.to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, GOLD[name[10:] + "_enc"])
    back = getattr(g711, name.replace("linear_to_", "") + "_to_linear")(
        torch.arange(256, dtype=torch.uint8, device=dev))
    np.testing.assert_array_equal(back.cpu().numpy(),
                                  GOLD[name[10:] + "_dec"])


@pytest.mark.parametrize("unroll", [8, 16, 32])
@pytest.mark.parametrize("variant", ["g721", "g723_24", "g723_40"])
def test_g72x_bank_equals_the_cpu_and_the_golden(dev, variant, unroll,
                                                 monkeypatch):
    monkeypatch.setattr(step_graph, "UNROLL", unroll)
    pcm = bank(600)
    st_d, codes_d = g72x.g72x_encode(
        variant, g72x.g72x_init_state(channels=4, device=dev),
        torch.from_numpy(pcm).to(dev))
    st_c, codes_c = g72x.g72x_encode(
        variant, g72x.g72x_init_state(channels=4, device="cpu"),
        torch.from_numpy(pcm))
    assert torch.equal(codes_d.cpu(), codes_c)
    assert tree_equal(st_d, st_c)
    np.testing.assert_array_equal(codes_d[0].cpu().numpy(),
                                  GOLD[f"{variant}_codes"][:600])
    _, pcm_d = g72x.g72x_decode(
        variant, g72x.g72x_init_state(channels=4, device=dev), codes_d)
    np.testing.assert_array_equal(pcm_d[0].cpu().numpy(),
                                  GOLD[f"{variant}_dec"][:600])


def test_step_scan_counts_its_graphs(dev, monkeypatch):
    monkeypatch.setattr(step_graph, "UNROLL", 16)
    for k in step_graph.scan_stats:
        step_graph.scan_stats[k] = 0
    g72x.g72x_encode("g721", g72x.g72x_init_state(channels=2, device=dev),
                     torch.zeros(2, 100, dtype=torch.int16, device=dev))
    assert step_graph.scan_stats["graphs"] == 1
    assert step_graph.scan_stats["replays"] == 100 // 16 - 1


@pytest.mark.parametrize("unroll", [8, 32])
def test_cvsd_bank_equals_the_cpu(dev, unroll, monkeypatch):
    monkeypatch.setattr(step_graph, "UNROLL", unroll)
    p = cvsd._CvsdParams()
    pcm = bank(700)
    st_d, bits_d = cvsd.cvsd_encode_bits(
        p, cvsd.cvsd_init_state(p, channels=4, device=dev),
        torch.from_numpy(pcm).to(dev))
    st_c, bits_c = cvsd.cvsd_encode_bits(
        p, cvsd.cvsd_init_state(p, channels=4, device="cpu"),
        torch.from_numpy(pcm))
    assert torch.equal(bits_d.cpu(), bits_c) and tree_equal(st_d, st_c)
    vals = bits_d * 128
    _, dec_d = cvsd.cvsd_decode_bits(
        p, cvsd.cvsd_init_state(p, channels=4, device=dev), vals)
    _, dec_c = cvsd.cvsd_decode_bits(
        p, cvsd.cvsd_init_state(p, channels=4, device="cpu"), vals.cpu())
    assert torch.equal(dec_d.cpu(), dec_c)


def test_gsm_bank_equals_the_cpu_and_the_golden(dev):
    pcm = bank(160 * 6)
    st_d, fr_d = gsm.gsm_fr_encode(
        gsm.gsm_init_encode_state(channels=4, device=dev),
        torch.from_numpy(pcm).to(dev))
    st_c, fr_c = gsm.gsm_fr_encode(
        gsm.gsm_init_encode_state(channels=4, device="cpu"),
        torch.from_numpy(pcm))
    assert torch.equal(fr_d.cpu(), fr_c) and tree_equal(st_d, st_c)
    np.testing.assert_array_equal(fr_d[0].cpu().numpy().reshape(-1),
                                  GOLD["gsm_frames"][:6 * 33])
    sd_d, out_d = gsm.gsm_fr_decode(
        gsm.gsm_init_decode_state(channels=4, device=dev), fr_d)
    sd_c, out_c = gsm.gsm_fr_decode(
        gsm.gsm_init_decode_state(channels=4, device="cpu"), fr_c)
    assert torch.equal(out_d.cpu(), out_c) and tree_equal(sd_d, sd_c)
    np.testing.assert_array_equal(out_d[0].cpu().numpy(),
                                  GOLD["gsm_dec"][:960])


def chain(dev, block, in_port, out_port, chunk):
    g = Graph()
    pin = g.add_input(in_port)
    pout = g.add_output(out_port)
    g.connect(pin, block, pout)
    return StreamExecutor(g, chunk_size=chunk, device=dev)


VOC_BLOCKS = [
    ("G721Encode", lambda: __import__("grtpu_torch.vocoder",
                                      fromlist=["x"]).G721Encode(),
     torch.int16, torch.uint8, 1, 300),
    ("CvsdEncode", lambda: cvsd.CvsdEncode(), torch.int16, torch.uint8, 1,
     264),
    ("GsmFrEncode", lambda: gsm.GsmFrEncode(), torch.int16, torch.uint8, 33,
     480),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", VOC_BLOCKS, ids=[c[0] for c in VOC_BLOCKS])
def test_vocoder_blocks_in_the_executor(dev, case, mode):
    _, make, din, dout, vlen, chunk = case
    x = torch.from_numpy(GOLD["input"][:1440].astype(np.int16))
    got = chain(dev, make(), Port(din), Port(dout, vlen), chunk).run(
        x.to(dev), device_loop=mode == "device_loop")
    want = chain("cpu", make(), Port(din), Port(dout, vlen), chunk).run(x)
    assert torch.equal(got.cpu(), want)


def test_codec2_blocks_refuse_device_loop(dev):
    x = torch.from_numpy(GOLD["input"][:320].astype(np.int16)).to(dev)
    ex = chain(dev, codec2.Codec2Encode(name="c2"), Port(torch.int16),
               Port(torch.uint8, 7), 320)
    with pytest.raises(ValueError, match=r"c2 \(Codec2Encode\)"):
        ex.run(x, device_loop=True)
    frames = ex.run(x)
    assert frames.device.type == "cuda"
    np.testing.assert_array_equal(frames.cpu().numpy().reshape(-1),
                                  codec2.Codec2().encode(x.cpu().numpy()))


BLOCKS = [
    ("DpllBB", lambda: misc.DpllBB(7.3, 0.2), torch.uint8, torch.uint8, 0.0),
    ("Threshold", lambda: misc.Threshold(-0.3, 0.3), torch.float32,
     torch.float32, 0.0),
    ("IqComp", lambda: misc.IqComp(0.01), torch.complex64, torch.complex64,
     1e-5),
    ("CtcssSquelch", lambda: misc.CtcssSquelch(8000.0, 100.0, 0.005, 1024),
     torch.float32, torch.float32, 1e-6),
    ("HrptPll", lambda: noaa.HrptPll(alpha=0.05), torch.complex64,
     torch.float32, 3e-5),
]


def block_input(dtype, n, rng):
    if dtype == torch.uint8:
        x = np.zeros(n, np.uint8)
        x[np.cumsum(7 + rng.randint(-1, 2, n // 7))[:n // 8]] = 1
        return x
    if dtype == torch.complex64:
        return np.exp(1j * (0.01 * np.arange(n) + 0.7 * np.sign(
            rng.randn(n)))).astype(np.complex64)
    t = np.arange(n) / 8000.0
    return (np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 100 * t)
            + 0.1 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("case", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_sample_loops_both_modes_and_the_cpu(dev, case):
    _, make, din, dout, tol = case
    x = torch.from_numpy(block_input(din, 3000, np.random.RandomState(2)))
    outs = [chain(dev, make(), Port(din), Port(dout), 1000).run(
        x.to(dev), device_loop=loop) for loop in (False, True)]
    assert torch.equal(outs[0], outs[1])
    want = chain("cpu", make(), Port(din), Port(dout), 1000).run(x)
    err = float((outs[0].cpu() - want).abs().max()) if tol else 0.0
    if tol:
        assert err <= tol
    else:
        assert torch.equal(outs[0].cpu(), want)


@pytest.mark.parametrize("mode", MODES)
def test_burst_tagger_tags_on_the_card(dev, mode):
    n = 4000
    mag = np.zeros(n, np.float32)
    for a in (10, 990, 1500, 3000):
        mag[a:a + 37] = 1.0
    sig = (np.arange(n) + 1j).astype(np.complex64)
    tags = {}
    for where in (dev, "cpu"):
        g = Graph()
        ps = g.add_input(Port(torch.complex64))
        pm = g.add_input(Port(torch.float32))
        bt = misc.BurstTagger(0.5)
        sink = gengen.VectorSink(torch.complex64, name="s")
        g.connect(ps, (bt, 0))
        g.connect(pm, (bt, 1))
        g.connect(bt, sink)
        ex = StreamExecutor(g, chunk_size=1000, device=where)
        ex.run(torch.from_numpy(sig).to(where), torch.from_numpy(mag).to(where),
               device_loop=mode == "device_loop" and where != "cpu")
        tags[str(where)] = sorted((t.offset, t.value)
                                  for t in ex.sink_tags["s"])
    assert tags["cuda"] == tags["cpu"]
    assert [o for o, _ in tags["cpu"]] == [10, 47, 990, 1027, 1500, 1537,
                                           3000, 3037]


@pytest.mark.parametrize("chunk", [5000, 100_003])
def test_hrpt_deframer_equals_the_cpu_at_ragged_chunks(dev, chunk):
    rng = np.random.RandomState(7)
    nw = noaa.HRPT_MINOR_FRAME_WORDS
    w = rng.randint(0, 1024, 2 * nw).astype(np.int64)
    w[:6] = w[nw:nw + 6] = noaa.HRPT_SYNC_WORDS
    bits = noaa.encode_words(w)
    x = np.concatenate([rng.randint(0, 2, 37).astype(np.uint8),
                        np.stack([1 - bits, bits], 1).reshape(-1)])
    blk = noaa.HrptDeframer()
    sd, sc, got = blk.init_state(), blk.init_state(), []
    sd = {k: v.to(dev) for k, v in sd.items()}
    for i in range(0, len(x), chunk):
        piece = torch.from_numpy(x[i:i + chunk])
        sd, (yd, nd) = blk.apply(sd, piece.to(dev))
        sc, (yc, nc) = blk.apply(sc, piece)
        assert int(nd) == int(nc) and tree_equal(sd, sc)
        assert torch.equal(yd[:int(nd)].cpu(), yc[:int(nc)])
        got.append(yc[:int(nc)].numpy())
    np.testing.assert_array_equal(np.concatenate(got).astype(np.int64)
                                  & 0x3FF, w)
