"""``StreamExecutor.run(device_loop=True)`` on the card: captured runs held
bit-identical to the eager run.

Each executor path that ``chip_smoke.py`` drives runs eagerly and under
``device_loop`` on the same input, in executors of their own: the WBFM chain
with its audio FIR on the hand kernel, the tuner -> WBFM chain, the
64-channel ``PfbChannelizer`` graph, the DMR variable-rate stream, a
``NoiseSource`` graph (its counter-based stream replayed), the
``PfbClockSync`` and ``Agc`` loops, and a checkpoint taken between two
captured runs.  The hand kernels' launch counts under replay are one a chunk,
and a block that reads the card from the host inside ``apply`` makes the
capture raise, naming the block.  Every test needs an NVIDIA GPU (marker
``cuda``) and skips elsewhere.  The file imports no JAX; from the
repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_executor.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Block, Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks import analog, gengen, stream  # noqa: E402
from grtpu_torch.blocks import pfb as pfb_blocks  # noqa: E402
from grtpu_torch.blocks.filter import FirFilter, FreqXlatingFirFilter  # noqa: E402
from grtpu_torch.digital.blocks import ClockRecoveryMMFF, FourLevelSlicer  # noqa: E402
from grtpu_torch.models.fm import FmDeemph, WfmRcv  # noqa: E402
from grtpu_torch.ops import cuda_fir  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def chain_graph(blocks, in_dtype):
    g = Graph()
    pin = g.add_input(Port(in_dtype))
    g.connect(pin, *blocks, g.add_output(blocks[-1].out_ports[0]))
    return g


def both(build, x, chunk, dev, runs=2, **kw):
    """(eager outputs, device_loop outputs, the device_loop executor) over
    ``runs`` consecutive runs of ``x`` (``x`` None: steps=kw['steps'])."""
    eager = StreamExecutor(build(), chunk_size=chunk, device=dev)
    loop = StreamExecutor(build(), chunk_size=chunk, device=dev)
    args = () if x is None else (x,)
    want = [eager.run(*args, **kw) for _ in range(runs)]
    got = [loop.run(*args, device_loop=True, **kw) for _ in range(runs)]
    torch.cuda.synchronize()
    return want, got, loop


def assert_equal_runs(want, got):
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def fm_tone(n, fs=256e3, seed=0):
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    return msg.astype(np.float32)


def wbfm_kernel_graph():
    from grtpu_torch.blocks.analog import FrequencyModulator, QuadratureDemod

    taps = firdes.low_pass(1.0, 256e3, 15e3, 3.2e3, firdes.Window.HAMMING)
    return chain_graph([FrequencyModulator(2 * np.pi * 75e3 / 256e3),
                        QuadratureDemod(256e3 / (2 * math.pi * 75e3)),
                        FirFilter(8, taps, "fff", impl="kernel"),
                        FmDeemph(32e3, 75e-6)], torch.float32)


def test_wbfm_kernel_path_and_launches_under_replay(dev):
    """The main path: 16 chunks of 65,536 twice; the captured output equals
    the eager one bit for bit, and fir_decim_mma_fwd and the de-emphasis'
    iir1_fwd count one launch a chunk each (one eager warm-up, then one a
    replay)."""
    x = torch.from_numpy(fm_tone(16 * 65536)).to(dev)
    eager = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536, device=dev)
    loop = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536, device=dev)
    want = [eager.run(x) for _ in range(2)]
    before = dict(cuda_fir.launches)
    got = [loop.run(x, device_loop=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert_equal_runs(want, got)
    moved = {k: cuda_fir.launches[k] - before[k] for k in before}
    assert moved["fir_decim_mma_fwd"] == 32
    assert moved["iir1_fwd"] == 32
    assert sum(moved.values()) == 64
    assert all(p.graph is not None
               for p in loop._device_loop.pieces.values())


def test_tuner_wbfm(dev):
    taps = firdes.low_pass(1.0, 2.048e6, 100e3, 50e3)
    r = np.random.RandomState(1)
    n = 8 * 131072
    x = np.exp(2j * np.pi * (0.1953125 * np.arange(n)
                             + np.cumsum(0.02 * r.randn(n)))).astype(np.complex64)

    def build():
        return chain_graph([FreqXlatingFirFilter(8, taps, 400e3, 2.048e6),
                            WfmRcv(256e3, 8, impl="kernel")], torch.complex64)

    want, got, _ = both(build, torch.from_numpy(x).to(dev), 131072, dev)
    assert_equal_runs(want, got)


def test_tuner_on_the_kernel_counts_its_ccc_launches(dev):
    """Config #1 with the tuner on the hand kernel's complex-taps mode:
    the captured runs equal the eager ones bit for bit, each chunk is one
    ccc launch of the decimating kernel, counted under fir_decim_cc too, and
    the carried phase after the runs equals the exact one (a centre of a
    sixth of the rate, whose phase a chunk's end does not bring back to 0)."""
    from fractions import Fraction

    taps = firdes.low_pass(1.0, 2.4e6, 100e3, 50e3)
    r = np.random.RandomState(3)
    n = 8 * 131072
    x = np.exp(2j * np.pi * (0.1953125 * np.arange(n)
                             + np.cumsum(0.02 * r.randn(n)))).astype(np.complex64)

    tuners = []

    def build():
        tuners.append(FreqXlatingFirFilter(8, taps, 400e3, 2.4e6,
                                           impl="kernel"))
        return chain_graph([tuners[-1], WfmRcv(256e3, 8, impl="kernel")],
                           torch.complex64)

    before = dict(cuda_fir.launches)
    want, got, loop = both(build, torch.from_numpy(x).to(dev), 131072, dev)
    assert_equal_runs(want, got)
    moved = {k: cuda_fir.launches[k] - before[k] for k in before}
    # 8 chunks a run, 2 runs, eager and device_loop: the tuner's and the
    # audio FIR's launches, the de-emphasis', and the tuner's again as ccc
    assert moved["fir_decim_cc"] == 32
    assert moved["fir_decim_mma_fwd"] == 64
    assert moved["iir1_fwd"] == 32
    assert sum(moved.values()) == 128
    phase = loop.state["blocks"][str(tuners[-1].uid)]
    turns = (-Fraction(400e3) / Fraction(2.4e6) * 2 * n) % 1
    assert turns != 0
    assert phase.dtype == torch.float64
    assert abs(math.remainder(float(phase) - 2 * math.pi * float(turns),
                              2 * math.pi)) < 1e-9


def test_pfb_channelizer_graph(dev):
    r = np.random.RandomState(2)
    x = torch.from_numpy((r.randn(1 << 20) + 1j * r.randn(1 << 20))
                         .astype(np.complex64)).to(dev)
    want, got, _ = both(lambda: chain_graph(
        [pfb_blocks.PfbChannelizer(64)], torch.complex64), x, 1 << 17, dev)
    assert_equal_runs(want, got)
    assert got[0].shape == ((1 << 20) // 64, 64)


def test_dmr_vr_stream(dev):
    """The variable-rate DMR graph: pieces before the push, one host read a
    push, the emission piece once per emission; outputs and emission counts
    equal to the eager run's."""
    from grtpu_torch.blocks.analog import QuadratureDemod
    from grtpu_torch.digital.modems import Fsk4Modem

    modem = Fsk4Modem(samples_per_symbol=10, device=dev)
    dibits = np.random.RandomState(3).randint(0, 4, 2400).astype(np.uint8)
    x = modem.modulate(dibits)

    def build():
        return chain_graph([QuadratureDemod(1.0 / modem.sensitivity),
                            FirFilter(1, modem.rx_taps / 10, "fff", impl="mxu"),
                            ClockRecoveryMMFF(10, 0.25 * 0.05 ** 2, 0.5, 0.05,
                                              0.005),
                            FourLevelSlicer(3.0)], torch.complex64)

    want, got, _ = both(build, x, 4096, dev)
    assert_equal_runs(want, got)
    assert got[0].shape[0] > 2000


def test_noise_source_graph(dev):
    def build():
        g = Graph()
        o = g.add_output(Port(torch.complex64))
        g.connect(gengen.NoiseSource("gaussian", 0.5, 11, dtype=torch.complex64),
                  FirFilter(2, np.ones(8, np.float32) / 8, "ccf", impl="mxu"), o)
        return g

    want, got, _ = both(build, None, 8192, dev, steps=6)
    assert_equal_runs(want, got)


def test_sequential_loops(dev):
    """PfbClockSync (a variable-rate block of ~400 one-element ops a symbol)
    and Agc (a per-sample loop) at small chunks."""
    sps, nfilts = 4, 32
    r = np.random.RandomState(9)
    bits = r.randint(0, 2, 300) * 2 - 1
    wave = np.repeat(bits, sps).astype(np.complex64)
    mf = firdes.root_raised_cosine(nfilts, nfilts * sps, 1.0, 0.35,
                                   11 * sps * nfilts)

    want, got, _ = both(lambda: chain_graph(
        [pfb_blocks.PfbClockSync(float(sps), 2 * np.pi / 100, mf, nfilts)],
        torch.complex64), torch.from_numpy(wave).to(dev), 400, dev)
    assert_equal_runs(want, got)
    x = torch.from_numpy((np.exp(0.2j * np.arange(1024))).astype(np.complex64))
    want, got, _ = both(lambda: chain_graph([analog.Agc(1e-3, 1.0, 0.5)],
                                            torch.complex64), x.to(dev), 256,
                        dev)
    assert_equal_runs(want, got)


def test_checkpoint_between_captured_runs(dev, tmp_path):
    """A checkpoint saved after a device_loop run resumes, in a fresh
    executor, into a device_loop run: both halves equal one eager run."""
    x = torch.from_numpy(fm_tone(12 * 65536, seed=4)).to(dev)
    want = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536,
                          device=dev).run(x)
    ex = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536, device=dev)
    first = ex.run(x[:6 * 65536], device_loop=True)
    path = str(tmp_path / "wbfm.npz")
    ex.save_checkpoint(path)
    resumed = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536,
                             device=dev)
    resumed.load_checkpoint(path)
    second = resumed.run(x[6 * 65536:], device_loop=True)
    assert torch.equal(torch.cat([first, second]), want)


def test_graphs_freed_by_the_collector_do_not_break_a_capture(dev):
    """An executor whose graphs are kept only by a reference cycle, freed by
    the garbage collector while another executor captures, must not
    invalidate that capture (the collector is held off during it)."""
    import gc

    x = torch.from_numpy(fm_tone(4 * 65536)).to(dev)
    old = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536, device=dev)
    old.run(x, device_loop=True)
    del old
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        want = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536,
                              device=dev).run(x)
        got = StreamExecutor(wbfm_kernel_graph(), chunk_size=65536,
                             device=dev).run(x, device_loop=True)
    finally:
        gc.set_threshold(*threshold)
    assert torch.equal(got, want)


class _ReadsTheCard(Block):
    """A block that reads a value back to the host inside apply."""

    def __init__(self):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__("reads_the_card")

    def apply(self, state, x):
        return state, x * float(x.abs().max().item() > 0)


def test_host_read_in_apply_raises(dev):
    """The first chunk runs eagerly; the capture of the second raises and
    names the block; nothing falls back to the eager step."""
    ex = StreamExecutor(chain_graph([stream.Copy(), _ReadsTheCard()],
                                    torch.float32), chunk_size=1024, device=dev)
    with pytest.raises(RuntimeError, match="reads_the_card.apply"):
        ex.run(torch.ones(4096, device=dev), device_loop=True)
    # the state is the one the run started from; an eager run still works
    y = ex.run(torch.ones(2048, device=dev))
    assert torch.equal(y, torch.ones(2048, device=dev))
