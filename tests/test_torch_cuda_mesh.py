"""The mesh executor and the parallel package on the card.

Meshes of logical shards on one card: the WBFM graph's kernel route on a
(2, 2) mesh within 1e-4 of the same mesh on mxu (the kernel's launches
counted), a mesh against one device per channel, ``run(device_loop=True)``
(one CUDA graph for the whole mesh step, or a DeviceLoop a channel)
``torch.equal`` to the stepwise run, the sharded bank's replayed step equal
to its eager step, meshes whose entries are the CPU and the card (lanes,
and the halo and state copied between devices), and the windowed M&M on
the card equal to its rows run alone and to the CPU.  Every test needs an NVIDIA GPU (marker ``cuda``) and skips
elsewhere.  The file imports no JAX; from the repository root on a GPU
machine:

    python -m pytest tests/test_torch_cuda_mesh.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.digital import loops  # noqa: E402
from grtpu_torch.digital.blocks import ClockRecoveryMMCC  # noqa: E402
from grtpu_torch.models.fm import WfmRcv  # noqa: E402
from grtpu_torch.ops import cuda_fir  # noqa: E402
from grtpu_torch.parallel import sharded_fm  # noqa: E402
from grtpu_torch.parallel.mesh import Mesh  # noqa: E402
from grtpu_torch.runtime.mesh_executor import MeshExecutor, make_mesh  # noqa: E402

pytestmark = pytest.mark.cuda

NCHAN, CHUNK = 4, 8192


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def wfm_graph(impl="kernel"):
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.float32))
    g.connect(pin, WfmRcv(256e3, 8, impl=impl), pout)
    return g


def bank_iq(n, seed=0):
    r = np.random.RandomState(seed)
    t = np.arange(n) / 256e3
    f = 1000.0 + 300.0 * np.arange(NCHAN)[:, None]
    msg = 0.5 * np.sin(2 * np.pi * f * t) + 0.05 * r.randn(NCHAN, n)
    return np.exp(1j * np.cumsum(2 * np.pi * 75e3 / 256e3 * msg, axis=1)
                  ).astype(np.complex64)


def mesh(shape, dev):
    return make_mesh(shape[0] * shape[1], [dev] * (shape[0] * shape[1]),
                     time=shape[0])


def test_mesh_kernel_route_within_its_twin(dev):
    iq = bank_iq(4 * CHUNK)
    for name in cuda_fir.launches:
        cuda_fir.launches[name] = 0
    y = MeshExecutor(wfm_graph("kernel"), mesh((2, 2), dev), NCHAN,
                     chunk_size=CHUNK).run(iq)
    assert cuda_fir.launches["fir_decim_mma_fwd"] == NCHAN * 2 * 4
    ref = MeshExecutor(wfm_graph("mxu"), mesh((2, 2), dev), NCHAN,
                       chunk_size=CHUNK).run(iq)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1)])
def test_logical_mesh_equals_one_device(dev, shape):
    iq = bank_iq(3 * CHUNK, seed=1)
    y = MeshExecutor(wfm_graph(), mesh(shape, dev), NCHAN,
                     chunk_size=CHUNK).run(iq)
    for c in range(NCHAN):
        ref = StreamExecutor(wfm_graph(), chunk_size=CHUNK, device=dev).run(
            iq[c])
        if shape[0] == 1:
            assert torch.equal(y[c], ref)
        else:
            torch.testing.assert_close(y[c], ref, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_device_loop_equals_eager(dev, shape):
    iq = bank_iq(4 * CHUNK, seed=2)
    eager = MeshExecutor(wfm_graph(), mesh(shape, dev), NCHAN,
                         chunk_size=CHUNK)
    loop = MeshExecutor(wfm_graph(), mesh(shape, dev), NCHAN,
                        chunk_size=CHUNK)
    for _ in range(2):          # the second run replays the captured graph
        assert torch.equal(loop.run(iq, device_loop=True), eager.run(iq))
    assert loop._loop.graph.graph is not None


def mm_graph():
    sps = 4
    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.complex64))
    g.connect(pin, ClockRecoveryMMCC(sps, 0.25 * 0.175 ** 2, 0.5, 0.175,
                                     0.005), pout)
    return g


def mm_iq(n=3 * 1024, sps=4):
    r = np.random.RandomState(6)
    sym = (np.sign(r.randn(NCHAN, n // sps))
           + 1j * np.sign(r.randn(NCHAN, n // sps)))
    return np.repeat(sym, sps, axis=1).astype(np.complex64)


def test_vr_mesh_device_loop_equals_stepwise(dev):
    iq = mm_iq()
    cmesh = Mesh(np.array([dev] * NCHAN, dtype=object), ("chan",))
    ref = MeshExecutor(mm_graph(), cmesh, NCHAN, chunk_size=1024).run(iq)
    got = MeshExecutor(mm_graph(), cmesh, NCHAN, chunk_size=1024).run(
        iq, device_loop=True)
    for c in range(NCHAN):
        assert torch.equal(got[c], ref[c])


@pytest.mark.parametrize("devs", [("cpu", "cuda"), ("cuda", "cpu")])
def test_mixed_chan_mesh_equals_each_device(dev, devs):
    """Channels on the CPU and on the card in one mesh: those whose entry
    is not the executor's own device run through a lane, their inputs,
    states and outputs copied across; each channel torch.equal to a
    single-device executor on its own device.  device_loop, which captures
    on one card, refuses the mesh."""
    iq = bank_iq(3 * CHUNK, seed=3)
    mex = MeshExecutor(wfm_graph(), Mesh([list(devs)], ("time", "chan")),
                       NCHAN, chunk_size=CHUNK)
    y = mex.run(iq)
    assert y.device.type == devs[0] and len(mex._lanes) == 1
    for c in range(NCHAN):
        d = devs[c // (NCHAN // 2)]
        ref = StreamExecutor(wfm_graph(), chunk_size=CHUNK, device=d).run(
            iq[c])
        assert torch.equal(y[c].cpu(), ref.cpu())
    with pytest.raises(ValueError, match="one card"):
        mex.run(iq, device_loop=True)


@pytest.mark.parametrize("devs", [("cpu", "cuda"), ("cuda", "cpu")])
def test_mixed_time_mesh_within_one_device(dev, devs):
    """Time shards on the CPU and on the card: every chunk the halo goes
    from one device to the other and the de-emphasis state is chained
    across them; each channel within grtpu's time-sharding tolerance of one
    device.  The FIR takes its plain (mxu) route on both devices."""
    iq = bank_iq(3 * CHUNK, seed=4)
    mesh2 = Mesh([[devs[0]], [devs[1]]], ("time", "chan"))
    y = MeshExecutor(wfm_graph("mxu"), mesh2, NCHAN, chunk_size=CHUNK).run(iq)
    for c in range(NCHAN):
        ref = StreamExecutor(wfm_graph("mxu"), chunk_size=CHUNK,
                             device=dev).run(iq[c])
        torch.testing.assert_close(y[c].to(dev), ref, atol=2e-6, rtol=1e-5)


def test_mixed_chan_mesh_vr_device_loop(dev):
    """A variable-rate chain under device_loop on a mesh of the CPU and the
    card: one DeviceLoop a channel on its own device (a lane's on the
    card), torch.equal to the stepwise mesh run, and each channel to a
    single-device executor on its device."""
    iq = mm_iq()
    cmesh = Mesh(["cpu", dev], ("chan",))
    ref = MeshExecutor(mm_graph(), cmesh, NCHAN, chunk_size=1024).run(iq)
    got = MeshExecutor(mm_graph(), cmesh, NCHAN, chunk_size=1024).run(
        iq, device_loop=True)
    for c in range(NCHAN):
        d = "cpu" if c < NCHAN // 2 else dev
        one = StreamExecutor(mm_graph(), chunk_size=1024, device=d).run(iq[c])
        assert torch.equal(got[c], ref[c])
        assert torch.equal(ref[c].cpu(), one.cpu())


def test_sharded_bank_replayed_equals_eager(dev):
    m = sharded_fm.make_mesh(4, [dev] * 4)
    bank = sharded_fm.ShardedWfmBank(m, nchannels=8)
    fast, slow = bank.jitted(), bank.step_fn()
    st_f = st_s = bank.init_state()
    for step in range(3):
        iq, _ = bank.example_inputs(t_per_shard=8192, seed=step)
        a_f, st_f, p_f = fast(iq, st_f)
        a_s, st_s, p_s = slow(iq, st_s)
        assert torch.equal(a_f, a_s) and torch.equal(st_f, st_s)
        assert torch.equal(p_f, p_s)


def test_windowed_mm_batch_on_card_equals_rows(dev):
    """The windowed M&M on the card (a CUDA graph replay a 32 symbols): a
    batch's rows equal each stream run alone, and the CPU's eager run."""
    rng = np.random.RandomState(4)
    x = (np.repeat(rng.choice([-1.0, 1.0], (3, 400)), 4, axis=1)[:, 1:]
         + 0.05 * rng.randn(3, 1599)).astype(np.float32)
    st = loops.mm_windowed_init_state(4.0, 0.5, device=dev)
    bst = loops.MMWinState(*(f.expand(3).clone() for f in st))
    xb = torch.from_numpy(x).to(dev)
    yb, _ = loops.clock_recovery_mm_ff_windowed(xb, bst, 4, 0.01, 0.1, W=16)
    for r in range(3):
        y1, _ = loops.clock_recovery_mm_ff_windowed(xb[r], st, 4, 0.01, 0.1,
                                                    W=16)
        assert torch.equal(yb[r], y1)
        y_cpu, _ = loops.clock_recovery_mm_ff_windowed(
            torch.from_numpy(x[r]), loops.mm_windowed_init_state(
                4.0, 0.5, device="cpu"), 4, 0.01, 0.1, W=16)
        assert torch.equal(y1.cpu(), y_cpu)
