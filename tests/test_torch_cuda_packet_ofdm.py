"""Messages, stream tags, the packet layer and the OFDM receiver on the card.

Held against the eager run and the CPU: the tags of CorrelateAccessCodeTag
(device records) and of an input pad, through PacketDecoder, equal between
eager and ``run(device_loop=True)`` and to the CPU run; the packet stream's
payloads equal; the OfdmReceiver graph's outputs ``torch.equal`` between the
two modes, its frame flags equal to the CPU run's, its BER at most 1e-3 and
its channel estimate within 1e-4 of the CPU's (cuFFT and the card's
reductions round otherwise than the CPU's: decisions, not floats, are held
equal across devices); the receiver vmapped over a bank of channels gives
each channel's bits, flags and counts of a loop over the channels (floats
within 1e-4: a batched reduction sums in its own order), and one CUDA graph
of the vmapped step replays it exactly; and a checkpoint taken mid-frame
resumes bit for bit, eagerly and under ``device_loop``.  Every
test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.  The file
imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_packet_ofdm.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks.gengen import VectorSink  # noqa: E402
from grtpu_torch.digital import ofdm, packet  # noqa: E402
from grtpu_torch.digital.correlate import CorrelateAccessCodeTag  # noqa: E402
from grtpu_torch.digital.packet_blocks import PacketDecoder, PacketEncoder  # noqa: E402
from grtpu_torch.runtime.tags import Tag  # noqa: E402

pytestmark = pytest.mark.cuda
CHAN_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def packet_bits(npkts, payload_len, seed=3):
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, payload_len).astype(np.uint8)
                for _ in range(npkts)]
    parts = [rng.integers(0, 2, 70).astype(np.uint8)]
    for p in payloads:
        parts += [packet.make_packet(bytes(p)),
                  rng.integers(0, 2, 90).astype(np.uint8)]
    bits = np.concatenate(parts + [np.zeros(2048, np.uint8)])
    return bits[: len(bits) // 512 * 512], payloads


def tag_graph(payload_len):
    g = Graph()
    pin = g.add_input(Port(torch.uint8))
    cat = CorrelateAccessCodeTag(packet.DEFAULT_ACCESS_CODE_BITS, key="sync",
                                 name="cat")
    dec = PacketDecoder("byte", payload_length=payload_len, name="dec")
    g.connect(pin, cat, dec, VectorSink(dtype=torch.uint8, name="sink"))
    return g, dec


def run_tags(device, bits, device_loop, payload_len=32):
    g, dec = tag_graph(payload_len)
    ex = StreamExecutor(g, chunk_size=512, vr_chunks={dec: payload_len},
                        device=device)
    ex.add_tags(0, [Tag(5, "in", 1), Tag(2000, "in", 2)])
    ex.run(bits, device_loop=device_loop)
    sink = next(b for b in ex.order if b.name == "sink")
    tags = sorted((t.offset, t.key, t.value) for t in ex.sink_tags["sink"])
    return tags, sink.data()


def test_tags_and_packets_eager_device_loop_and_cpu(dev):
    bits, payloads = packet_bits(8, 32)
    ref = run_tags("cpu", bits, False)
    for device_loop in (False, True, True):
        tags, data = run_tags(dev, bits, device_loop)
        assert tags == ref[0]
        np.testing.assert_array_equal(data, ref[1])
    assert sum(k == "sync" for _, k, _ in ref[0]) == 8
    sent = np.concatenate(payloads)
    np.testing.assert_array_equal(ref[1], sent[: len(ref[1])])
    assert len(ref[1]) >= 7 * 32


def test_packet_encoder_decoder_on_the_card(dev):
    from grtpu_torch.blocks.gengen import PackedToUnpacked

    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)

    def run(device, device_loop):
        g = Graph()
        pin = g.add_input(Port(torch.float32))
        pout = g.add_output(Port(torch.float32))
        g.connect(pin, PacketEncoder("float", payload_length=64),
                  PackedToUnpacked(1), PacketDecoder("float", payload_length=64),
                  pout)
        return StreamExecutor(g, chunk_size=512, device=device).run(
            x, device_loop=device_loop).cpu()

    ref = run("cpu", False)
    assert torch.equal(run(dev, False), ref) and torch.equal(run(dev, True), ref)
    np.testing.assert_array_equal(ref.numpy(), x[: len(ref)])


def ofdm_stream(modem, nsym, nframes, seed=0, snr_db=20.0, cfo=0.002,
                bits_out=None):
    rng = np.random.RandomState(seed)
    sigs = []
    for _ in range(nframes):
        bits = rng.randint(0, 2, nsym * modem.occupied * 2).astype(np.uint8)
        if bits_out is not None:
            bits_out.append(bits)
        tx = modem.modulate(bits)
        sig = np.concatenate([np.zeros(200, np.complex64), tx])
        sig = sig * np.exp(1j * cfo * np.arange(len(sig)))
        n0 = (np.abs(tx) ** 2).mean() / 10 ** (snr_db / 10)
        sigs.append((sig + (rng.randn(len(sig)) + 1j * rng.randn(len(sig)))
                     * np.sqrt(n0 / 2)).astype(np.complex64))
    return np.concatenate(sigs + [np.zeros(1200, np.complex64)])


def rx_executor(device, nsym=8, chunk_spans=4):
    m = ofdm.OfdmModem(device=device)
    rx = ofdm.OfdmReceiver(m, nsym_data=nsym)
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    outs = [g.add_output(Port(torch.uint8)), g.add_output(Port(torch.uint8)),
            g.add_output(Port(torch.complex64, m.occupied))]
    g.connect(pin, rx)
    g.connect((rx, 0), ofdm.OfdmFrameSink(m), outs[0])
    g.connect((rx, 1), outs[1])
    g.connect((rx, 2), outs[2])
    span = (nsym + 2) * rx.sym_len
    return StreamExecutor(g, chunk_size=chunk_spans * span,
                          vr_chunks={rx: chunk_spans * nsym}, device=device)


def test_ofdm_receiver_modes_and_cpu(dev):
    sent = []
    x = ofdm_stream(ofdm.OfdmModem(device="cpu"), 8, 12, bits_out=sent)
    ref = rx_executor("cpu").run(x)
    eager = rx_executor(dev)
    loop = rx_executor(dev)
    for run in range(2):
        a = eager.run(x)
        b = loop.run(x, device_loop=True)
        assert all(torch.equal(u, v) for u, v in zip(a, b)), run
    assert torch.equal(a[1].cpu(), ref[1]) and int(ref[1].sum()) == 12
    bits = a[0].cpu().numpy()
    assert len(bits) == len(ref[0]) == 12 * len(sent[0])
    assert (bits != np.concatenate(sent)).mean() <= 1e-3
    err = float((a[2].cpu() - ref[2]).abs().max() / ref[2].abs().max())
    assert err <= CHAN_TOL, err


def test_ofdm_checkpoint_mid_frame_resumes(dev, tmp_path):
    nsym, chunk_spans = 8, 1
    x = ofdm_stream(ofdm.OfdmModem(device="cpu"), nsym, 4, seed=5)
    probe = rx_executor("cpu", nsym, chunk_spans)
    chunk = probe.chunk_size
    x = x[: len(x) // chunk * chunk]
    rx_of = lambda ex: next(v for v in ex.state["blocks"].values()   # noqa: E731
                            if isinstance(v, dict))
    for c in range(len(x) // chunk):
        probe.run(x[c * chunk:(c + 1) * chunk])
        if 0 < int(rx_of(probe)["sym_left"]) < nsym:
            break
    cut = (c + 1) * chunk
    full = rx_executor(dev, nsym, chunk_spans).run(x)
    for device_loop in (False, True):
        ex = rx_executor(dev, nsym, chunk_spans)
        first = ex.run(x[:cut], device_loop=device_loop)
        path = str(tmp_path / f"ofdm{int(device_loop)}.npz")
        ex.save_checkpoint(path)
        ex2 = rx_executor(dev, nsym, chunk_spans)
        ex2.load_checkpoint(path)
        rest = ex2.run(x[cut:], device_loop=device_loop)
        for j in range(3):
            assert torch.equal(torch.cat([first[j], rest[j]]), full[j])


def test_ofdm_bank_vmapped_equals_a_loop_and_replays(dev):
    """torch.func.vmap over OfdmReceiver.apply: 8 channels, each chunk's
    outputs equal to the single-channel apply of that channel, eagerly and
    replayed from a CUDA graph."""
    C, nsym, spans = 8, 8, 4
    m = ofdm.OfdmModem(device=dev)
    rx = ofdm.OfdmReceiver(m, nsym_data=nsym)
    cm = ofdm.OfdmModem(device="cpu")
    chunk = spans * (nsym + 2) * rx.sym_len
    xs = [ofdm_stream(cm, nsym, 3, seed=10 + c) for c in range(C)]
    nch = min(len(x) for x in xs) // chunk
    X = torch.from_numpy(np.stack([x[: nch * chunk] for x in xs])).to(dev)
    h = rx.history - 1
    init = {k: v.to(dev) for k, v in rx.init_state().items()}
    vapply = torch.func.vmap(rx.apply)
    sink = ofdm.OfdmFrameSink(m)

    def sink_bits(v):
        return sink.apply((), v)[1]

    def bank_state():
        return {k: v.expand((C,) + v.shape).clone() for k, v in init.items()}

    # the bank, eagerly
    st, tail, bank = bank_state(), torch.zeros(C, h, dtype=torch.complex64,
                                               device=dev), []
    for c in range(nch):
        xin = torch.cat([tail, X[:, c * chunk:(c + 1) * chunk]], 1)
        tail = xin[:, -h:]
        st, (ys, nv) = vapply(st, xin)
        bank.append((ys, nv))
    # each channel alone
    for ch in range(C):
        s1, t1 = dict(init), torch.zeros(h, dtype=torch.complex64, device=dev)
        for c in range(nch):
            xin = torch.cat([t1, X[ch, c * chunk:(c + 1) * chunk]])
            t1 = xin[-h:]
            s1, (ys, nv) = rx.apply(s1, xin)
            assert int(nv) == int(bank[c][1][ch])
            bys = [b[ch] for b in bank[c][0]]
            assert torch.equal(ys[1], bys[1])
            assert torch.equal(sink_bits(ys[0]), sink_bits(bys[0]))
            for j in (0, 2):
                err = (ys[j] - bys[j]).abs().max() / ys[j].abs().max()
                assert float(err) <= CHAN_TOL, (ch, c, j, float(err))
    # the bank's step replayed from a CUDA graph over static buffers
    sst = bank_state()
    sx = torch.zeros(C, h + chunk, dtype=torch.complex64, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        warm = vapply(bank_state(), sx)        # fills caches outside capture
    torch.cuda.current_stream().wait_stream(stream)
    del warm
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_st, (out_ys, out_nv) = vapply(sst, sx)
    tail = torch.zeros(C, h, dtype=torch.complex64, device=dev)
    for k in sst:
        sst[k].copy_(init[k].expand_as(sst[k]))
    for c in range(nch):
        sx.copy_(torch.cat([tail, X[:, c * chunk:(c + 1) * chunk]], 1))
        tail = sx[:, -h:].clone()
        graph.replay()
        assert torch.equal(out_nv, bank[c][1])
        assert all(torch.equal(a, b) for a, b in zip(out_ys, bank[c][0]))
        for k in sst:
            sst[k].copy_(out_st[k])
