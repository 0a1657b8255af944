"""The file sources, the flowgraph compiler and the native ring on the card.

``FileSource`` and ``WavFileSource`` keep their data on the card and gather
each chunk there, so ``run(device_loop=True)`` replays them from CUDA graphs
and must be ``torch.equal`` to the eager run; the WBFM flowgraph spec (file
-> tuner -> ``WfmRcv`` on the hand kernel, and on ``mxu``) within 1e-4 of
the same spec on the CPU; the native ring feeding ``stream()`` equal to
``run()`` on the card.  Every test needs an NVIDIA GPU (marker ``cuda``) and
skips elsewhere.  The file imports no JAX; from the repository root on a
GPU machine:

    python -m pytest tests/test_torch_cuda_io_grc.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks import gengen  # noqa: E402
from grtpu_torch.grc import FlowgraphSpec  # noqa: E402
from grtpu_torch.io import file as iofile, native  # noqa: E402
from grtpu_torch.models.fm import WfmRcv  # noqa: E402
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


def cnoise(n, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n) + 1j * r.randn(n)).astype(np.complex64)


def fm_capture(n, fs, offset=400e3, seed=0):
    """A WBFM station (1 kHz tone, 75 kHz deviation) ``offset`` Hz off
    centre, with noise."""
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    x = np.exp(1j * (2 * np.pi * offset * t
                     + np.cumsum(2 * np.pi * 75e3 / fs * msg)))
    return (x + 0.01 * cnoise(n, seed)).astype(np.complex64)


@pytest.mark.parametrize("repeat", [False, True], ids=["once", "repeat"])
def test_file_source_device_loop_equals_eager(dev, tmp_path, repeat):
    path = str(tmp_path / "in.cfile")
    x = cnoise(5000, 1)
    iofile.save_capture(path, x)
    outs = {}
    for mode in ("eager", "device_loop"):
        g = Graph()
        sink = gengen.VectorSink(torch.complex64)
        g.connect(iofile.FileSource(path, torch.complex64, repeat=repeat),
                  sink)
        ex = StreamExecutor(g, chunk_size=1024, device=dev)
        ex.run(steps=6, device_loop=mode == "device_loop")
        outs[mode] = sink.captured[0]
    assert outs["eager"].device.type == "cuda"
    assert torch.equal(outs["eager"], outs["device_loop"])
    got = outs["eager"].cpu().numpy()
    np.testing.assert_array_equal(got[:5000], x)
    np.testing.assert_array_equal(got[5000:], x[:1144] if repeat else 0)


def test_wav_source_device_loop_equals_eager(dev, tmp_path):
    path = str(tmp_path / "in.wav")
    iofile.save_wav(path, 8000, 0.5 * np.random.RandomState(2).randn(3000, 2))
    outs = {}
    for mode in ("eager", "device_loop"):
        g = Graph()
        src = iofile.WavFileSource(path)
        sinks = [gengen.VectorSink(torch.float32) for _ in range(2)]
        for c in range(2):
            g.connect((src, c), sinks[c])
        StreamExecutor(g, chunk_size=512, device=dev).run(
            steps=6, device_loop=mode == "device_loop")
        outs[mode] = [s.captured[0] for s in sinks]
    for a, b in zip(outs["eager"], outs["device_loop"]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(outs["eager"][1][:3000].cpu().numpy(),
                                  iofile.load_wav(path)[1][:, 1])


def wbfm_spec(cap, impl):
    taps = firdes.low_pass(1.0, 2.048e6, 100e3, 50e3)
    return FlowgraphSpec.from_dict({
        "options": {"chunk_size": 65536, "steps": 4},
        "blocks": [
            {"id": "src", "key": "gr_file_source", "params": {"path": cap}},
            {"id": "tuner", "key": "gr_freq_xlating_fir_filter_xxx",
             "params": {"decimation": 8, "taps": [float(v) for v in taps],
                        "center_freq": 400e3, "sampling_freq": 2.048e6}},
            {"id": "rcv", "key": "blks2_wfm_rcv",
             "params": {"quad_rate": 256000.0, "audio_decimation": 8,
                        "impl": impl}},
            {"id": "out", "key": "gr_vector_sink_x",
             "params": {"dtype": "float32"}}],
        "connections": [["src", 0, "tuner", 0], ["tuner", 0, "rcv", 0],
                        ["rcv", 0, "out", 0]]})


@pytest.mark.parametrize("impl", ["kernel", "mxu"])
@pytest.mark.parametrize("mode", ["eager", "device_loop"])
def test_wbfm_spec_on_the_card_equals_the_cpu(dev, tmp_path, impl, mode):
    """The spec's audio on the card within 1e-4 of the CPU run; with
    ``impl: kernel`` fir_decim_mma_fwd is launched once a chunk."""
    cap = str(tmp_path / "cap.cfile")
    iofile.save_capture(cap, fm_capture(1 << 18, 2.048e6))
    g, byid = wbfm_spec(cap, impl).build()
    StreamExecutor(g, chunk_size=65536, device="cpu").run(steps=4)
    want = byid["out"].data()
    g, byid = wbfm_spec(cap, impl).build()
    for name in cuda_fir.launches:
        cuda_fir.launches[name] = 0
    StreamExecutor(g, chunk_size=65536, device=dev).run(
        steps=4, device_loop=mode == "device_loop")
    got = byid["out"].data()
    assert got.shape == want.shape == (4096,)
    assert np.abs(got - want).max() <= 1e-4
    assert cuda_fir.launches["fir_decim_mma_fwd"] == (4 if impl == "kernel"
                                                      else 0)


def test_ring_feeds_stream_on_the_card(dev, tmp_path):
    """Capture file -> native ring -> stream() over WfmRcv on the hand
    kernel: torch.equal to run() on the card."""
    if not native.available():
        pytest.fail("the native ring did not build (no host C++ compiler)")
    x = fm_capture(1 << 16, 256e3, offset=0.0, seed=3)
    path = str(tmp_path / "cap.cfile")
    x.tofile(path)

    def executor():
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.float32))
        g.connect(pin, WfmRcv(256e3, 8, impl="kernel"), pout)
        return StreamExecutor(g, chunk_size=4096, device=dev)

    want = executor().run(torch.from_numpy(x).to(dev))
    src = native.NativeFileSource(path, np.complex64)
    got = torch.cat(list(executor().stream(src.chunks(4096))))
    src.close()
    assert got.device.type == "cuda"
    assert torch.equal(got, want)
