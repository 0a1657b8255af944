"""The tuner, the FM family and the polyphase filterbank on the card, held
against the same calls on CPU tensors.

These paths reach no new hand kernel; the tests check that their torch ops
give the CPU's answers on a CUDA device: float32 matmul paths to 1e-5 of the
peak (TF32 off; ``precision="f32"`` raises while it is on), the bf16 modes
to the same 1e-5 (both devices round the same operands), the clock-sync
loops' decisions exactly, and that no new entry point falls back to the
CPU.  Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The file imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_pfb.py -m cuda --noconftest
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks import analog, gengen, pfb as pfb_blocks  # noqa: E402
from grtpu_torch.blocks.filter import FreqXlatingFirFilter  # noqa: E402
from grtpu_torch.models.fm import NbfmRx, NbfmTx, WfmRcv, WfmRcvPll  # noqa: E402
from grtpu_torch.ops import dsp, pfb  # noqa: E402
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


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def run_graph(chain, x, chunk, device, in_dtype=torch.complex64):
    g = Graph()
    pin = g.add_input(Port(in_dtype))
    ports = list(chain[-1].out_ports)
    if len(ports) == 1:
        g.connect(pin, *chain, g.add_output(ports[0]))
    else:
        g.connect(pin, *chain)
        for i, port in enumerate(ports):
            g.connect((chain[-1], i), g.add_output(port))
    y = StreamExecutor(g, chunk_size=chunk, device=device).run(x)
    return tuple(v.cpu() for v in (y if isinstance(y, tuple) else (y,)))


@pytest.mark.parametrize("oversample", [1, 2])
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
def test_channelize_matches_cpu(dev, precision, oversample):
    N = 64
    proto = pfb.design_channelizer_taps(N, 12)
    x = torch.from_numpy(cnoise((1 << 14) + len(proto), 1))
    cpu = pfb.channelize(x, proto, N, oversample, precision)
    got = pfb.channelize(x.to(dev), proto, N, oversample, precision)
    assert got.device.type == "cuda"
    assert rel(got.cpu(), cpu) < 1e-5


def test_channelize_f32_refuses_tf32(dev):
    proto = pfb.design_channelizer_taps(8, 4)
    x = torch.from_numpy(cnoise(256 + len(proto), 2)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            pfb.channelize(x, proto, 8)
        pfb.channelize(x, proto, 8, precision="bf16x3")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_synthesize_matches_cpu(dev):
    N = 16
    proto = pfb.design_channelizer_taps(N, 12)
    ch = torch.from_numpy(cnoise((1024 + 11) * N, 3).reshape(-1, N))
    assert rel(pfb.synthesize(ch.to(dev), proto).cpu(),
               pfb.synthesize(ch, proto)) < 1e-5


@pytest.mark.parametrize("p,q", [(3, 2), (160, 147), (2, 3)])
def test_arb_resample_matches_cpu(dev, p, q):
    rate = Fraction(p, q)
    taps = pfb.design_arb_resampler_taps(float(rate))
    kp = -(-len(taps) // 32)
    x = torch.from_numpy(cnoise(4 * (q * 40 + kp - 1), 4).reshape(4, -1))
    assert rel(pfb.arb_resample(x.to(dev), taps, rate).cpu(),
               pfb.arb_resample(x, taps, rate)) < 1e-5


def test_tuner_wfm_graph_matches_cpu(dev):
    """Config #1 on the card: the kernel path launches the hand kernel and
    stays within 1e-4 of the CPU's float32 chain."""
    from grtpu_torch.ops import cuda_fir

    fs = 2.048e6
    t = np.arange(1 << 16) / fs
    x = (np.exp(1j * (2 * np.pi * 400e3 * t + 18.75 * np.sin(2 * np.pi * 1e3 * t)))
         + 0.01 * cnoise(1 << 16, 5)).astype(np.complex64)

    def chain(impl):
        return [FreqXlatingFirFilter(8, firdes.low_pass(1.0, fs, 100e3, 50e3),
                                     400e3, fs), WfmRcv(256e3, 8, impl=impl)]

    cpu, = run_graph(chain("mxu"), x, 16384, "cpu")
    before = cuda_fir.launches["fir_decim_mma_fwd"]
    got, = run_graph(chain("kernel"), x, 16384, dev)
    assert cuda_fir.launches["fir_decim_mma_fwd"] == before + 4
    assert rel(got, cpu) < 1e-4
    plain, = run_graph(chain("mxu"), x, 16384, dev)
    assert rel(plain, cpu) < 1e-5


def test_nbfm_loopback_and_stereo_match_cpu(dev):
    msg = (0.5 * np.sin(2 * np.pi * 800 * np.arange(1 << 14) / 16e3)
           ).astype(np.float32)
    chain = lambda: [NbfmTx(16e3, 64e3), NbfmRx(16e3, 64e3)]  # noqa: E731
    cpu, = run_graph(chain(), msg, 4096, "cpu", torch.float32)
    got, = run_graph(chain(), msg, 4096, dev, torch.float32)
    assert (got - cpu).abs().max().item() < 2e-4   # a float32 prefix sum
    # a stereo composite with its 19 kHz pilot: the receiver divides the
    # filtered pilot by its magnitude, so without one it would amplify
    # rounding noise
    t = np.arange(1 << 15) / 256e3
    left = 0.4 * np.sin(2 * np.pi * 700 * t)
    right = 0.4 * np.sin(2 * np.pi * 2200 * t)
    comp = ((left + right) / 2 + 0.1 * np.sin(2 * np.pi * 19000 * t)
            + (left - right) * np.sin(2 * np.pi * 38000 * t) / 2)
    iq = np.exp(1j * np.cumsum(2 * np.pi * 75e3 / 256e3 * comp)
                ).astype(np.complex64)
    for a, b in zip(run_graph([WfmRcvPll(256e3, 8)], iq, 8192, dev),
                    run_graph([WfmRcvPll(256e3, 8)], iq, 8192, "cpu")):
        assert rel(a, b) < 1e-5


def test_sources_and_rotator_on_the_card(dev):
    """Sources produce on the executor's device; the float32 phase ramp
    (taken in float64) is the CPU's."""
    for blk in (analog.SigSource(48000.0, "cos", 1234.5),
                gengen.NoiseSource("gaussian", 1.0, seed=3),
                gengen.NullSource()):
        g = Graph()
        g.connect(blk, g.add_output(blk.out_ports[0]))
        y = StreamExecutor(g, chunk_size=1024, device=dev).run(steps=2)
        assert y.device.type == "cuda" and y.shape == (2048,)
    x = torch.from_numpy(cnoise(1 << 15, 6))
    yc, pc = dsp.rotate(x, torch.tensor(0.5), 0.7353)
    yg, pg = dsp.rotate(x.to(dev), torch.tensor(0.5, device=dev), 0.7353)
    assert rel(yg.cpu(), yc) < 1e-5 and abs(float(pg) - float(pc)) < 1e-6


def test_noise_source_reproducible_on_the_card(dev):
    def draw(seed):
        blk = gengen.NoiseSource("gaussian", 1.0, seed=seed,
                                 dtype=torch.complex64)
        g = Graph()
        g.connect(blk, g.add_output(blk.out_ports[0]))
        return StreamExecutor(g, chunk_size=1 << 14, device=dev).run(steps=4)

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(a.real.var().item() - 0.5) < 0.02
    assert abs(a.imag.var().item() - 0.5) < 0.02


def _bpsk(nsym, sps, seed):
    from grtpu_torch.ops.fir import interp_fir_filter

    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, nsym) * 2 - 1
    tx = firdes.root_raised_cosine(sps, sps, 1.0, 0.35, 11 * sps)
    xh = torch.cat([torch.zeros(-(-len(tx) // sps) - 1, dtype=torch.complex64),
                    torch.from_numpy((bits + 0j).astype(np.complex64))])
    wave = interp_fir_filter(xh, tx, sps).numpy()
    t = np.arange(len(wave))
    return (np.interp(t - 1.3, t, wave.real)
            + 0.02 * rng.standard_normal(len(t))).astype(np.complex64)


def test_pfb_clock_sync_decisions_match_cpu(dev):
    sps, nfilts = 4, 32
    x = _bpsk(300, sps, 7)
    mf = firdes.root_raised_cosine(nfilts, nfilts * sps, 1.0, 0.35,
                                   11 * sps * nfilts)
    outs = []
    for d in ("cpu", dev):
        y, n, _ = pfb_blocks.pfb_clock_sync(
            torch.from_numpy(x).to(d), pfb_blocks.pfb_clock_sync_init(
                nfilts, device=d), float(sps), mf, nfilts, 2 * np.pi / 100)
        outs.append(y[:int(n)].cpu())
    assert outs[0].shape == outs[1].shape and outs[0].shape[0] > 250
    assert torch.equal(outs[0].real > 0, outs[1].real > 0)
    assert (outs[0] - outs[1]).abs().max().item() < 1e-4
    blk = lambda: [pfb_blocks.PfbClockSync(float(sps), 2 * np.pi / 100, mf,  # noqa: E731
                                           nfilts)]
    a, = run_graph(blk(), x[:1024], 512, "cpu")
    b, = run_graph(blk(), x[:1024], 512, dev)
    assert a.shape == b.shape and torch.equal(a.real > 0, b.real > 0)


def test_agc_and_pll_match_cpu(dev):
    x = (np.exp(1j * (0.2 * np.arange(1024) + 0.7)) * 0.6
         + 0.05 * cnoise(1024, 8)).astype(np.complex64)
    for make in (lambda: [analog.Agc(1e-3, 1.0, 0.5)],
                 lambda: [analog.Agc2()],
                 lambda: [analog.PllCarrierTracking(0.05, 0.5, -0.5)]):
        a, = run_graph(make(), x, 512, "cpu")
        b, = run_graph(make(), x, 512, dev)
        assert (a - b).abs().max().item() < 1e-3
