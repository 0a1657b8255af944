"""The trellis / ATSC slice's two hand kernels and its long loops on the card.

``viterbi_fwd`` is held ``torch.equal`` to its plain twin (every step is one
float32 add, compare or subtract in the twin's order) on FSMs of 4, 8, 64
and 256 states and one with missing edges, on both routes where the warp
route takes the FSM (row counts and lengths that fill no whole warp or tile
included), with fixed and free start and end states and on ties; the 12-phase ATSC decode on the card equals the CPU's.
``dfe_feedback_fwd`` sums in another order than ``torch.dot``: decisions
and final ring equal to the twin's, outputs within 1e-4, from one symbol to
more than a multiple of 32.  Each kernel replays from a CUDA graph.
Launches are counted, and recorded at capture and counted at each replay
under ``run(device_loop=True)``.  The chunked FPLL and the bit
timing loop replay one step from a CUDA graph: their outputs equal the same
steps run eagerly, and the bit timing loop's decisions (and symbols) equal
the CPU's; an equalizer that loads taps after its training sweep was
captured trains the loaded taps.  Every test needs an NVIDIA GPU (marker
``cuda``) and skips elsewhere.  The file imports no JAX; from the repository root on a GPU
machine:

    python -m pytest tests/test_torch_cuda_trellis_atsc.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks.gengen import ChunksToSymbols  # noqa: E402
from grtpu_torch.models import atsc, atsc_rf as rf  # noqa: E402
from grtpu_torch.ops import cuda_fir, cuda_trellis as ct  # noqa: E402
from grtpu_torch.trellis import (FSM, TrellisEncoder, TrellisMetrics,  # noqa: E402
                                 ViterbiDecoder)

pytestmark = pytest.mark.cuda
DFE_TOL = 1e-4
FSM4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


FSMS = {"fsm4": FSM4, "atsc": atsc.atsc_trellis_fsm(),
        "ccsds": FSM.from_convolutional(1, 2, [[0o117, 0o155]]),
        "isi256": FSM.from_isi(4, 5),
        # in-degrees 3 and 1: missing edges, which take the block route
        "gappy": FSM(2, 2, 2, NS=[0, 1, 0, 0], OS=[0, 1, 0, 1]),
        # one state (32 rows a warp); three (a pad lane in each row of 4)
        "one": FSM(2, 1, 2, NS=[0, 0], OS=[0, 1]),
        "three": FSM(2, 3, 2, NS=[1, 2, 2, 0, 0, 1], OS=[0, 1, 1, 0, 0, 1]),
        # K=5 and K=6 codes: rows of 16 and 32 lanes (the butterfly max)
        "k5": FSM.from_convolutional(1, 2, [[0o23, 0o35]]),
        "k6": FSM.from_convolutional(1, 2, [[0o53, 0o75]]),
        # every state reachable from every state: in-degree 8, and 5 (three
        # pad edges a lane, three pad lanes a row of 8)
        "deg8": FSM(8, 8, 8, NS=[i for s in range(8) for i in range(8)],
                    OS=[(s + 3 * i) % 8 for s in range(8) for i in range(8)]),
        "deg5": FSM(5, 5, 4, NS=[i for s in range(5) for i in range(5)],
                    OS=[(2 * s + i) % 4 for s in range(5) for i in range(5)])}


VITERBI_CASES = [("fsm4", 64, 512), ("atsc", 12, 3000), ("ccsds", 8, 700),
                 ("isi256", 3, 400),
                 ("fsm4", 13, 1000),    # rows no multiple of a warp's 8
                 ("atsc", 13, 77),      # nor of its 4; T no multiple of 32
                 ("gappy", 9, 500),
                 ("fsm4", 5, 1),        # one step
                 ("one", 40, 100), ("three", 11, 300),
                 ("k5", 9, 300), ("k6", 5, 700),
                 ("deg8", 7, 200), ("deg5", 6, 150)]


def routes(name):
    """The routes an FSM takes: both where the warp route takes it (S <= 32
    and no missing edge), the block route else."""
    f = FSMS[name]
    complete = bool((f.PS >= 0).all())
    if ct.viterbi_route(f.S, f.PS.shape[1], f.O, complete) == "warp":
        return ("warp", "block")
    return ("block",)


@pytest.mark.parametrize("name,b,t,route", [
    (name, b, t, route) for name, b, t in VITERBI_CASES
    for route in routes(name)])
@pytest.mark.parametrize("st,en", [(0, -1), (-1, -1), (0, 0)])
def test_viterbi_kernel_equals_twin(dev, name, b, t, route, st, en):
    fsm = FSMS[name]
    m = torch.from_numpy(np.random.RandomState(b + t).rand(b, t, fsm.O)
                         .astype(np.float32)).to(dev)
    tab = ct.tables(fsm, dev)
    from grtpu_torch.ops._build import library

    deg = fsm.PS.shape[1]
    plan = ct.viterbi_plan(fsm.S, deg, fsm.O, b, t, route)
    code = int(route == "warp")
    assert library().viterbi_smem(code, fsm.S, deg, fsm.O, plan.steps,
                                  plan.tb_steps,
                                  plan.warps) == plan.smem <= 48 * 1024
    before = cuda_fir.launches["viterbi_fwd"]
    got = ct.viterbi_fwd(m, tab, st, en, _route=route)
    torch.cuda.synchronize()
    assert cuda_fir.launches["viterbi_fwd"] == before + 1
    assert torch.equal(got, ct.viterbi_ref(m, tab, st, en))


@pytest.mark.parametrize("route", ["warp", "block"])
def test_viterbi_ties_take_the_first_index(dev, route):
    """Integer metrics tie constantly: the first candidate wins on the card
    as in the twin (and in grtpu's argmax), on both routes."""
    m = torch.from_numpy(np.random.RandomState(3).randint(0, 3, (16, 600, 4))
                         .astype(np.float32)).to(dev)
    tab = ct.tables(FSM4, dev)
    assert torch.equal(ct.viterbi_fwd(m, tab, _route=route),
                       ct.viterbi_ref(m, tab))


@pytest.mark.parametrize("kernel", ["viterbi_fwd", "dfe_feedback_fwd"])
def test_kernel_replayed_from_a_cuda_graph(dev, kernel):
    """Each kernel captured into a CUDA graph (after a warm-up call) and
    replayed on new inputs copied into the captured ones: the replay equals
    an eager call on those inputs."""
    r = np.random.RandomState(11)
    if kernel == "viterbi_fwd":
        fsm = FSMS["atsc"]
        tab = ct.tables(fsm, dev)
        shape = (12, 2000, fsm.O)
        x = torch.from_numpy(r.rand(*shape).astype(np.float32)).to(dev)

        def call():
            return (ct.viterbi_fwd(x, tab),)
    else:
        wfb = torch.from_numpy((r.randn(192) * 0.02).astype(np.float32)).to(dev)
        ring = torch.from_numpy(r.choice(np.arange(-7.0, 8.0, 2.0), 192)
                                .astype(np.float32)).to(dev)
        shape = (5000,)
        x = torch.empty(shape, device=dev)

        def call():
            return ct.dfe_feedback(x, wfb, ring)

    def fresh():
        if kernel == "viterbi_fwd":
            return torch.from_numpy(r.rand(*shape).astype(np.float32))
        return torch.from_numpy((r.choice(np.arange(-7, 8, 2), shape[0])
                                 + r.randn(shape[0]) * 0.3).astype(np.float32))

    x.copy_(fresh().to(dev))
    call()                                   # warm-up: build and load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    for _ in range(2):
        x.copy_(fresh().to(dev))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, call()):
            assert torch.equal(got, want)


def test_atsc_trellis_decode_card_equals_cpu(dev):
    r = np.random.RandomState(5)
    dib = r.randint(0, 4, 12 * 1500).astype(np.int32)
    levels, _ = atsc.trellis_encode(dib)
    noisy = levels + r.randn(len(levels)) * 0.9
    got = atsc.trellis_decode(noisy, dev)
    np.testing.assert_array_equal(got, atsc.trellis_decode(noisy, "cpu"))
    assert (got != dib).mean() < 0.05


@pytest.mark.parametrize("nfb", [32, 192, 256])
@pytest.mark.parametrize("n", [1, 100, 4096, 4097])
def test_dfe_kernel_against_twin(dev, n, nfb):
    r = np.random.RandomState(nfb + n)
    ff = torch.from_numpy((r.choice(np.arange(-7, 8, 2), n)
                           + r.randn(n) * 0.3).astype(np.float32)).to(dev)
    wfb = torch.from_numpy((r.randn(nfb) * 0.02).astype(np.float32)).to(dev)
    ring = torch.from_numpy(r.choice(np.arange(-7.0, 8.0, 2.0), nfb)
                            .astype(np.float32)).to(dev)
    before = cuda_fir.launches["dfe_feedback_fwd"]
    y, ring_k = ct.dfe_feedback(ff, wfb, ring)
    torch.cuda.synchronize()
    assert cuda_fir.launches["dfe_feedback_fwd"] == before + 1
    y_ref, ring_ref = ct.dfe_feedback_ref(ff, wfb, ring)
    assert torch.equal(ct.slice8(y), ct.slice8(y_ref))
    assert (y - y_ref).abs().max().item() <= DFE_TOL
    assert torch.equal(ring_k, ring_ref)


def test_trellis_graph_device_loop_launches_at_replay(dev):
    k = 256
    bits = np.random.default_rng(0).integers(0, 2, 16 * k).astype(np.int32)
    bits.reshape(-1, k)[:, -2:] = 0          # each block ends in state 0
    pam = np.array([-1.5, -0.5, 0.5, 1.5], np.float32)

    def graph():
        g = Graph()
        i = g.add_input(Port(torch.int32))
        o = g.add_output(Port(torch.int32))
        g.connect(i, TrellisEncoder(FSM4),
                  ChunksToSymbols(pam, torch.int32, torch.float32),
                  TrellisMetrics(4, 1, pam), ViterbiDecoder(FSM4, k, 0, 0), o)
        return g

    x = torch.from_numpy(bits).to(dev)
    eager = StreamExecutor(graph(), chunk_size=2 * k, device=dev).run(x)
    before = cuda_fir.launches["viterbi_fwd"]
    loop = StreamExecutor(graph(), chunk_size=2 * k, device=dev)
    got = loop.run(x, device_loop=True)
    torch.cuda.synchronize()
    assert torch.equal(got, eager)
    np.testing.assert_array_equal(got.cpu().numpy(), bits)
    assert cuda_fir.launches["viterbi_fwd"] - before == 8   # one a chunk


def test_ccsds_blocks_under_device_loop(dev):
    """EncodeCcsds27 -> +-1 -> DecodeCcsds27 captures and replays: outputs
    torch.equal to the eager run and to the CPU's."""
    from grtpu_torch.fec.conv import DecodeCcsds27, EncodeCcsds27

    def graph():
        g = Graph()
        i = g.add_input(Port(torch.uint8))
        o = g.add_output(Port(torch.uint8))
        g.connect(i, EncodeCcsds27(),
                  ChunksToSymbols(np.array([-1.0, 1.0], np.float32),
                                  torch.uint8, torch.float32),
                  DecodeCcsds27(), o)
        return g

    data = np.random.RandomState(7).randint(0, 256, 512).astype(np.uint8)
    x = torch.from_numpy(data)
    cpu = StreamExecutor(graph(), chunk_size=128, device="cpu").run(x)
    eager = StreamExecutor(graph(), chunk_size=128, device=dev).run(x.to(dev))
    loop = StreamExecutor(graph(), chunk_size=128, device=dev).run(
        x.to(dev), device_loop=True)
    assert torch.equal(loop, eager)
    assert torch.equal(eager.cpu(), cpu)


@pytest.mark.parametrize("kind", ["viterbi_parallel", "siso", "sccc"])
def test_decoder_blocks_under_device_loop(dev, kind):
    """The log-depth Viterbi, the SISO and a turbo decoder as blocks: the
    captured runs torch.equal to the eager ones."""
    from grtpu_torch.trellis import Interleaver, ScccDecoder, SisoF

    k = 64
    msb = FSM(4, 4, 8, NS=[0, 1, 2, 3] * 4,
              OS=[0, 5, 3, 6, 4, 1, 7, 2, 7, 2, 4, 1, 3, 6, 0, 5])

    def block():
        if kind == "viterbi_parallel":
            return ViterbiDecoder(FSM4, k, 0, -1, parallel=True)
        if kind == "siso":
            return SisoF(FSM4, k, 0, -1)
        return ScccDecoder(FSM4, 0, -1, msb, 0, -1,
                           Interleaver.random(k, 5), k, 2)

    def graph():
        b = block()
        g = Graph()
        g.connect(g.add_input(b.in_ports[0]), b,
                  g.add_output(b.out_ports[0]))
        return g

    width = 8 if kind == "sccc" else 4
    x = torch.from_numpy(np.random.RandomState(4).rand(8 * k * width)
                         .astype(np.float32)).to(dev)
    chunk = 2 * k * width
    eager = StreamExecutor(graph(), chunk_size=chunk, device=dev).run(x)
    loop = StreamExecutor(graph(), chunk_size=chunk, device=dev).run(
        x, device_loop=True)
    assert torch.equal(loop, eager)


def test_fpll_chunked_replay_equals_eager_steps(dev):
    fs = 10.762238e6 * 2.5
    r = np.random.default_rng(1)
    n = 256 * 40 + 77
    x = torch.from_numpy((1.25 * np.cos(2 * np.pi * 0.26 * np.arange(n))
                          + r.standard_normal(n)).astype(np.float32)).to(dev)
    st0 = rf.fpll_init_state(0.26 * fs, fs, dev)
    st, y = rf.fpll_chunked(st0, x, fs)
    # the same chunks, each step eagerly
    s = torch.stack(list(st0))
    ys = []
    for c in range(n // 256 + 1):
        seg = x[c * 256:(c + 1) * 256]
        last = seg.shape[0] - 1
        seg = torch.cat([seg, seg.new_zeros(256 - seg.shape[0])])
        s, yc = rf._fpll_chunk(s, seg, rf._iir_alpha(fs), 2, last)
        ys.append(yc)
    assert torch.equal(y, torch.cat(ys)[:n])
    assert torch.equal(torch.stack(list(st)), s)


def test_bit_timing_loop_card_equals_cpu(dev):
    r = np.random.default_rng(42)
    segs = r.choice([-7, -5, -3, -1, 1, 3, 5, 7], size=(30, 832)).astype(
        np.float32)
    segs[:, :4] = [5, -5, -5, 5]
    from grtpu_torch.ops.fir import interp_fir_filter
    from grtpu_torch.utils import firdes

    rrc = firdes.root_raised_cosine(2.0, 2.0, 1.0, 0.115, 41).astype(
        np.float32)
    xs = interp_fir_filter(torch.cat([torch.zeros(20), torch.from_numpy(
        segs.reshape(-1))]), rrc, 2)
    nseg = int((len(xs) - rf.BTL_WINDOW) // (2.0 * 832))
    cpu = rf.bit_timing_loop(rf.btl_init_state(2.0, "cpu"), xs, nseg)
    card = rf.bit_timing_loop(rf.btl_init_state(2.0, dev), xs.to(dev), nseg)
    for a, b in zip(cpu[1:], card[1:]):
        assert torch.equal(a, b.cpu())
    for a, b in zip(cpu[0], card[0]):
        assert torch.equal(a, b.cpu())
    assert card[3][-5:].all()


def multipath_fields(n_fields):
    """Fields through the channel 1 + 0.45 z^-60 + 0.2 z^-150 with noise
    0.05, each as the window an equalizer takes."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 8, (n_fields * 312, 828)).astype(np.uint8)
    stream = rf.AtscFieldSyncMux()(data).astype(np.float32) * 2 - 7
    h = np.zeros(151, np.float32)
    h[0], h[60], h[150] = 1.0, 0.45, 0.2
    x = np.convolve(stream, h)[: len(stream)].astype(np.float32)
    x += 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    xp = np.concatenate([np.zeros(rf.EQ_CURSOR, np.float32), x,
                         np.zeros(rf.EQ_NTAPS, np.float32)])
    n = rf.SYMBOLS_PER_FIELD + rf.EQ_NTAPS - 1
    return [xp[f * rf.SYMBOLS_PER_FIELD: f * rf.SYMBOLS_PER_FIELD + n]
            for f in range(n_fields)]


def taps_of(eq):
    return [t.cpu() for t in ((eq.taps,) if hasattr(eq, "taps")
                              else (eq.wff, eq.wfb))]


@pytest.mark.parametrize("kind", ["nlms", "lms2"])
def test_equalizer_load_after_capture(dev, kind):
    """Taps loaded after the training sweep was captured are the ones the
    replays train: the card's equalizer, which captured its sweep on field
    0, loads taps trained elsewhere and processes field 1 as a fresh CPU
    equalizer that loaded the same taps does (outputs and taps within 1e-4,
    decisions equal away from a boundary)."""
    xf0, xf1 = multipath_fields(2)
    card = rf.EQUALIZERS[kind](device=dev)
    card.process_field(xf0)
    assert card._train.graph is not None
    other = rf.EQUALIZERS[kind](device=dev)
    other.process_field(xf1)
    loaded = [t.numpy().copy() for t in taps_of(other)]
    card.load(*loaded)
    cpu = rf.EQUALIZERS[kind](device="cpu")
    cpu.load(*loaded)
    got, want = card.process_field(xf1), cpu.process_field(xf1)
    for a, b, t0 in zip(taps_of(card), taps_of(cpu), loaded):
        assert not np.array_equal(b.numpy(), t0)     # the sweeps moved them
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=DFE_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=DFE_TOL)
    edge = np.abs(want[:, None] - np.arange(-6.0, 7.0, 2.0)).min(-1)
    clear = edge > DFE_TOL
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(np.round((got[clear] + 7) / 2).clip(0, 7),
                                  np.round((want[clear] + 7) / 2).clip(0, 7))
