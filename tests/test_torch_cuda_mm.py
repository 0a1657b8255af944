"""The M&M clock recovery kernel ``mm_fwd`` on the card.

Every call of ``clock_recovery_mm_ff`` and ``clock_recovery_mm_cc`` on a
CUDA tensor is one launch of ``mm_fwd``, held bit for bit (``torch.equal``
on ys, n_valid and the four state tensors) to the plain loop
``loops._mm_exact`` run on the same card: real and complex streams (the
complex error clipped), 200 chunks carried through ``rebase_mm_state``,
omega pinned at each limit, a stream end that freezes the state with slots
past it, streams longer than shared memory holds (staged in tiles), odd
lengths from 4 samples up, window pointers below, between and past the
samples, and symbols whose speculated sum the kernel has to check and make
again (``tests/_mm_cases.py``).  The DMR receive graph under
``run(device_loop=True)`` at the benchmark's chunk, 4,320, launches it once
a chunk, replays counted, and gives the CPU's dibits.
Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.  The
file imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_mm.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _mm_cases as mc  # noqa: E402
from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.blocks.analog import QuadratureDemod  # noqa: E402
from grtpu_torch.blocks.filter import FirFilter  # noqa: E402
from grtpu_torch.digital import loops  # noqa: E402
from grtpu_torch.digital.blocks import ClockRecoveryMMFF, FourLevelSlicer  # noqa: E402
from grtpu_torch.digital.modems import Fsk4Modem, awgn  # noqa: E402
from grtpu_torch.ops import cuda_fir, cuda_mm  # noqa: E402
from grtpu_torch.ops.mmse_interp import mmse_taps  # noqa: E402

pytestmark = pytest.mark.cuda
DMR = (10.0, 0.25 * 0.05 ** 2, 0.05, 0.005)     # the stream cell's loop
FAST = (4.0, 0.25 * 0.175 ** 2, 0.175, 0.005)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def levels(n, sps, seed, cplx=False, offset=0.0):
    return torch.from_numpy(mc.levels(n, sps, seed, cplx, offset))


def one_launch(fn):
    before = dict(cuda_fir.launches)
    out = fn()
    moved = {n: cuda_fir.launches[n] - before[n] for n in before
             if cuda_fir.launches[n] != before[n]}
    assert moved == {"mm_fwd": 1}
    return out


def kernel_and_plain(x, state, args, cc):
    """The routed call (one launch) and the plain loop, both on the card;
    asserts they are equal bit for bit and returns the kernel's result."""
    fn = loops.clock_recovery_mm_cc if cc else loops.clock_recovery_mm_ff
    got = one_launch(lambda: fn(x, state, *args))
    want = loops._mm_exact(x, state, *args, clip_err=cc)
    torch.cuda.synchronize()
    assert got[0].device == x.device and got[0].dtype == x.dtype
    assert torch.equal(got[0], want[0])
    assert got[1].dtype == torch.int32 and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert g.shape == () and g.dtype == w.dtype and torch.equal(g, w)
    return got


def init(dev, omega, mu, cc):
    return loops.mm_init_state(omega, mu, complex_mode=cc, device=dev)


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("n", [4, 5, 7, 8, 9, 31, 437, 4340, 4341])
def test_odd_lengths(dev, cc, n):
    x = levels(n, DMR[0], n, cplx=cc).to(dev)
    kernel_and_plain(x, init(dev, DMR[0], 0.5, cc), DMR, cc)


@pytest.mark.parametrize("cc", [False, True])
def test_two_hundred_chunks(dev, cc):
    """Chunk after chunk with the block's history kept, the state carried
    through rebase_mm_state from the kernel's own output; each chunk equal
    to the plain loop from the same state."""
    omega, chunk = FAST[0], 301
    hist = 8 + int(np.ceil(omega)) + 3
    x = levels(200 * chunk + hist, omega, 9, cplx=cc).to(dev)
    state = init(dev, omega, 0.5, cc)
    total = 0
    for c in range(200):
        seg = x[c * chunk:c * chunk + chunk + hist - 1]
        ys, nv, state = kernel_and_plain(seg, state, FAST, cc)
        total += int(nv)
        state = loops.rebase_mm_state(state, chunk)
    assert total > 0.9 * 200 * chunk / omega


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("side", [-1.0, 1.0])
def test_omega_pinned_at_each_limit(dev, cc, side):
    x = levels(2000, 8.0, 3, cplx=cc, offset=3.0 * side).to(dev)
    _, _, st = kernel_and_plain(x, init(dev, 8.0, 0.5, cc), (8.0, 2.0, 0.1, 0.01),
                                cc)
    assert float(st.omega) in (float(np.float32(7.92)), float(np.float32(8.08)))


@pytest.mark.parametrize("cc", [False, True])
def test_stream_end_freezes_the_state(dev, cc):
    x = levels(203, 3.0, 11, cplx=cc).to(dev)
    ys, nv, _ = kernel_and_plain(x, init(dev, 3.0, 0.9, cc), (3.0, 0.01, 0.2, 0.05),
                                 cc)
    nv = int(nv)
    assert nv < len(ys) - 2
    assert torch.equal(ys[nv:], ys[nv].expand(len(ys) - nv))


@pytest.mark.parametrize("cc", [False, True])
def test_longer_than_shared_memory(dev, cc):
    """A chunk past the largest tile: the kernel stages it in tiles."""
    n = cuda_mm.max_tile(cc) + 4320
    x = levels(n, DMR[0], 13, cplx=cc).to(dev)
    ys, nv, _ = kernel_and_plain(x, init(dev, DMR[0], 0.5, cc), DMR, cc)
    assert int(nv) > 0.99 * n / DMR[0]


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("j", [0, 300, 700])
def test_redoes_a_speculated_symbol(dev, cc, j):
    """A symbol whose fused multiply-adds round off the plain loop's sum
    (tests/_mm_cases.py's engineered window; the first symbol, one inside
    the first check's segment, one in the second): the kernel finds it,
    goes back and makes it exactly, and equals the plain loop."""
    x, w = mc.engineered(10 * j + 400, [j], cplx=cc)
    ys, _, _ = kernel_and_plain(torch.from_numpy(x).to(dev),
                                init(dev, DMR[0], 0.5, cc), DMR, cc)
    taps = mmse_taps()[64]
    got = ys[j].imag if cc else ys[j]
    assert float(got) == mc.fused_route(w, taps) != mc.fma_route(w, taps)


def test_redoes_a_symbol_in_a_restaged_tile(dev):
    """The same past the first tile of a stream longer than shared memory
    holds."""
    j = cuda_mm.max_tile(False) // 10 + 200
    x, w = mc.engineered(10 * j + 400, [j])
    ys, _, _ = kernel_and_plain(torch.from_numpy(x).to(dev),
                                init(dev, DMR[0], 0.5, False), DMR, False)
    assert float(ys[j]) == mc.fused_route(w, mmse_taps()[64])


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("base", [-37.0, 3.5, -2.25, 1e9])
def test_states_off_the_walkers_guess(dev, cc, base):
    """A window pointer below the stream, between samples or past its end:
    the walker's carried window offset guesses wrong, the check finds each
    such symbol, and the outputs are the plain loop's."""
    x = levels(3000, DMR[0], 21, cplx=cc).to(dev)
    state = init(dev, DMR[0], 0.5, cc)._replace(
        base=torch.tensor(base, dtype=torch.float32, device=dev))
    kernel_and_plain(x, state, DMR, cc)


def test_matches_the_cpu(dev):
    """The kernel on the card and the plain loop on the CPU, the same
    arithmetic on two devices."""
    for cc in (False, True):
        x = levels(4340, DMR[0], 17, cplx=cc)
        fn = loops.clock_recovery_mm_cc if cc else loops.clock_recovery_mm_ff
        got = fn(x.to(dev), init(dev, DMR[0], 0.5, cc), *DMR)
        want = fn(x, init("cpu", DMR[0], 0.5, cc), *DMR)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        for g, w in zip(got[2], want[2]):
            assert torch.equal(g.cpu(), w)


def test_state_on_the_cpu_is_moved(dev):
    """A state left on the CPU, which the plain loop takes as scalars."""
    x = levels(500, DMR[0], 19).to(dev)
    got = loops.clock_recovery_mm_ff(x, init("cpu", DMR[0], 0.5, False), *DMR)
    want = loops._mm_exact(x, init(dev, DMR[0], 0.5, False), *DMR,
                           clip_err=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_refuses_a_complex_ff_call(dev):
    x = levels(64, 4.0, 1, cplx=True).to(dev)
    with pytest.raises(TypeError, match="mm_ff"):
        loops.clock_recovery_mm_ff(x, init(dev, 4.0, 0.5, True), *FAST)


SPS = 10
CHUNK = 4320


def stream(nsym, seed):
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    dibits = np.random.RandomState(seed).randint(0, 4, nsym)
    return awgn(modem.modulate(dibits).numpy(), 15.0, seed=seed)


def dmr_graph(modem):
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.uint8))
    g.connect(pin, QuadratureDemod(1.0 / modem.sensitivity),
              FirFilter(1, modem.rx_taps / SPS, "fff", impl="mxu"),
              ClockRecoveryMMFF(omega=SPS, gain_omega=0.25 * 0.05 ** 2, mu=0.5,
                                gain_mu=0.05, omega_relative_limit=0.005),
              FourLevelSlicer(scale=3.0), pout)
    return g


def test_vr_graph_device_loop_one_launch_a_chunk(dev):
    """test_torch_cuda_dmr's graph under run(device_loop=True) at chunk
    4,320, two runs: one mm_fwd launch a chunk (each replay counted), the
    dibits equal to the CPU's, and to the eager run on the card."""
    x = stream(1300, 5)[:3 * CHUNK]
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    ref = StreamExecutor(dmr_graph(modem), chunk_size=CHUNK, device="cpu").run(x)
    eager = StreamExecutor(dmr_graph(modem), chunk_size=CHUNK, device=dev).run(x)
    loop = StreamExecutor(dmr_graph(modem), chunk_size=CHUNK, device=dev)
    before = dict(cuda_fir.launches)
    chunks0 = loop.loop_stats()["chunks"]
    got = [loop.run(x, device_loop=True) for _ in range(2)]
    torch.cuda.synchronize()
    moved = {k: cuda_fir.launches[k] - before[k] for k in before
             if cuda_fir.launches[k] != before[k]}
    chunks = loop.loop_stats()["chunks"] - chunks0
    assert chunks == 6
    assert moved == {"mm_fwd": chunks}
    assert loop.loop_stats()["replays"] > 0
    np.testing.assert_array_equal(got[0].cpu().numpy(), ref.numpy())
    np.testing.assert_array_equal(eager.cpu().numpy(), ref.numpy())
    assert len(got[1]) > 0.9 * len(ref)
