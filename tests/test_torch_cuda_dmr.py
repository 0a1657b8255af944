"""The DMR 4FSK receive slice on the card, held against the same calls on
CPU tensors.

The slice reaches no hand kernel; these tests check that its torch ops give
the CPU's answers on a CUDA device: the burst bank's pre-slicer levels to
atol 1e-4 and its dibits exactly, the variable-rate executor's dibits
exactly, and the chunked modem's dibits exactly.  Every test needs an NVIDIA
GPU (marker ``cuda``) and skips elsewhere.  The file imports no JAX; from
the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_dmr.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks.analog import QuadratureDemod  # noqa: E402
from grtpu_torch.blocks.filter import FirFilter  # noqa: E402
from grtpu_torch.digital.blocks import ClockRecoveryMMFF, FourLevelSlicer  # noqa: E402
from grtpu_torch.digital.modems import Fsk4Modem, awgn  # noqa: E402

pytestmark = pytest.mark.cuda
SPS = 10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def stream(nsym, seed, cfo_hz=0.0):
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    dibits = np.random.RandomState(seed).randint(0, 4, nsym)
    iq = modem.modulate(dibits).numpy()
    iq = iq * np.exp(1j * 2 * np.pi * cfo_hz / 48000 * np.arange(len(iq)))
    return awgn(iq, 15.0, seed=seed)


def test_burst_bank_matches_cpu(dev):
    x = np.stack([stream(1000, c, cfo_hz=10.0 * c - 40) for c in range(8)])
    gpu = Fsk4Modem(samples_per_symbol=SPS, device=dev)
    cpu = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    lg = gpu._burst_bank_fn(torch.from_numpy(x).to(dev))
    lc = cpu._burst_bank_fn(torch.from_numpy(x))
    assert (lg.cpu() - lc).abs().max().item() < 1e-4
    np.testing.assert_array_equal(gpu.demodulate_burst_bank(x),
                                  cpu.demodulate_burst_bank(x))


def _graph(modem):
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.uint8))
    g.connect(pin, QuadratureDemod(1.0 / modem.sensitivity),
              FirFilter(1, modem.rx_taps / SPS, "fff", impl="mxu"),
              ClockRecoveryMMFF(omega=SPS, gain_omega=0.25 * 0.05 ** 2, mu=0.5,
                                gain_mu=0.05, omega_relative_limit=0.005),
              FourLevelSlicer(scale=3.0), pout)
    return g


def test_vr_graph_matches_cpu(dev):
    x = stream(1200, 5)
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    got = StreamExecutor(_graph(modem), chunk_size=4096, device=dev).run(x)
    ref = StreamExecutor(_graph(modem), chunk_size=4096, device="cpu").run(x)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


def test_chunked_demod_matches_cpu(dev):
    x = stream(1500, 6)
    got = Fsk4Modem(samples_per_symbol=SPS, chunked=True, device=dev).demodulate(x)
    ref = Fsk4Modem(samples_per_symbol=SPS, chunked=True,
                    device="cpu").demodulate(x)
    np.testing.assert_array_equal(got, ref)
