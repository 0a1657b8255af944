"""The Hopper FIR kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
elsewhere.  The file imports no JAX, so it also runs on a machine without
it; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerances on max|kernel - twin| / max|twin|: f32 < 1e-5, bf16x3 < 1e-4,
bf16 < 3e-2 (bf16 products are exact in float32; the kernel and the twin
sum in different orders).  In a multi-stage cascade at bf16 each stage
re-rounds its output, so a last-bit difference in a sum can move a value by
one bf16 step; 3e-2 covers that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch.ops import cuda_fir as cf  # noqa: E402
from grtpu_torch.ops.fir import fir_filter  # noqa: E402

TOL = {"f32": 1e-5, "bf16x3": 1e-4, "bf16": 3e-2}
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def randn(dev, *shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("k,d,c,n", [(155, 8, 3, 8 * 1000), (31, 2, 2, 2 * 777),
                                     (1300, 1, 2, 3000), (7, 5, 1, 5 * 33),
                                     (4500, 1, 1, 2000), (2100, 3, 2, 3 * 500)])
def test_fir_decim(dev, precision, k, d, c, n):
    x = randn(dev, c, n + k - 1, seed=k)
    taps = randn(dev, k, seed=k + 1) / k
    got = cf.fir_decim(x, taps, d, precision=precision)
    ref = cf.fir_tile_ref(x, taps[None], d, 0, n // d, precision)
    torch.cuda.synchronize()
    assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
def test_tapsets_and_lead(dev, precision):
    x = randn(dev, 6, 2000, seed=3)
    ts = randn(dev, 3, 40, seed=4) / 40
    got = cf._tile(x, ts, 3, 39, 600, precision)
    ref = cf.fir_tile_ref(x, ts, 3, 39, 600, precision)
    assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("s,k,n", [(16, 256, 1 << 14), (2, 64, 384),
                                   (5, 17, 128 * 77)])
def test_fir_cascade(dev, precision, s, k, n):
    x = randn(dev, 2, n, seed=s)
    taps = randn(dev, k, seed=k) * 0.1
    got = cf.fir_cascade(x, taps, s, precision=precision)
    ref = cf.fir_cascade_ref(x, taps, s, precision)
    assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("k,lead,g,b,nout", [
    (64, 0, 1, 2, 77), (96, 95, 3, 6, 128 * 3 + 41), (256, 255, 3, 3, 20001),
    (513, 0, 1, 1, 128 * 130 + 5), (1300, 0, 1, 2, 3000),
    (4097, 4096, 1, 2, 1 << 16), (4097, 0, 2, 4, 128 * 300 + 1)])
def test_tensor_core_route(dev, precision, k, lead, g, b, nout):
    """fir_toeplitz_fwd against the twin at ragged shapes: streams shorter
    than one 128-sample row and no multiple of it, lead 0 and K-1, G tap
    sets, an odd output count, several segments and passes."""
    x = randn(dev, b, nout + k - 1 - lead, seed=k)
    ts = randn(dev, g, k, seed=k + 1) / np.sqrt(k)
    before = dict(cf.launches)
    got = cf._tile(x, ts, 1, lead, nout, precision)
    torch.cuda.synchronize()
    assert cf.launches["fir_toeplitz_fwd"] == before["fir_toeplitz_fwd"] + 1
    assert cf.launches["fir_tile_fwd"] == before["fir_tile_fwd"]
    ref = cf.fir_tile_ref(x, ts, 1, lead, nout, precision)
    assert torch.isfinite(got).all()
    assert rel(got, ref) < TOL[precision]
    plain = cf.fir_toeplitz_ref(x, ts, lead, nout, precision)
    assert rel(got, plain) < TOL[precision]


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_short_filters_keep_the_fma_route(dev, precision):
    x = randn(dev, 2, 1000 + 15, seed=8)
    taps = randn(dev, 16, seed=9) / 4
    before = dict(cf.launches)
    got = cf.fir_long(x[0], taps, precision=precision)
    assert cf.launches["fir_toeplitz_fwd"] == before["fir_toeplitz_fwd"]
    assert cf.launches["fir_tile_fwd"] == before["fir_tile_fwd"] + 1
    forced = cf._launch_tile(x[:1].contiguous(), taps[None].contiguous(), 1, 0,
                             1000, precision, _fma=True)[0]
    assert torch.equal(got, forced)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_filters_too_long_for_the_ring_take_the_fma_route(dev, precision):
    """The wrapper's shared-memory sizes are the library's, and one tap past
    _TZ_MAX_TAPS the call is an FMA launch that agrees with the twin."""
    from grtpu_torch.ops._build import library

    code = cf._PRECISION_CODE[precision]
    for k in (64, 256, 4097, cf._TZ_MAX_TAPS[precision]):
        assert library().fir_toeplitz_smem(code, k) == \
            cf._toeplitz_smem(precision, k)
    k = cf._TZ_MAX_TAPS[precision]
    ts = randn(dev, 2, k + 1, seed=11) / np.sqrt(k)
    x = randn(dev, 1, 1000 + k, seed=10)
    for kk, name in ((k, "fir_toeplitz_fwd"), (k + 1, "fir_tile_fwd")):
        before = dict(cf.launches)
        got = cf._tile(x[:, :1000 + kk - 1], ts[:1, :kk], 1, 0, 1000, precision)
        assert {n for n in cf.launches
                if cf.launches[n] != before[n]} == {name}
        ref = cf.fir_tile_ref(x[:, :1000 + kk - 1], ts[:1, :kk], 1, 0, 1000,
                              precision)
        assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("s,k,n", [(2, 256, 1 << 15), (16, 256, 1 << 15),
                                   (2, 64, 384), (16, 17, 128 * 77)])
def test_cascade_tensor_core_route(dev, precision, s, k, n):
    """The cascade's MMA stages against the twin and the forced FMA route."""
    x = randn(dev, 3, n, seed=s)
    taps = randn(dev, k, seed=k) * (0.05 if k == 256 else 1 / np.sqrt(k))
    before = dict(cf.launches)
    got = cf.fir_cascade(x, taps, s, precision=precision)
    assert cf.launches["fir_cascade_mma_fwd"] == before["fir_cascade_mma_fwd"] + 1
    assert cf.launches["fir_cascade_fwd"] == before["fir_cascade_fwd"]
    ref = cf.fir_cascade_ref(x, taps, s, precision)
    assert torch.isfinite(got).all()
    assert rel(got, ref) < TOL[precision]
    fma = cf._launch_cascade(x, taps, s, precision, _fma=True)
    assert cf.launches["fir_cascade_mma_fwd"] == before["fir_cascade_mma_fwd"] + 1
    assert cf.launches["fir_cascade_fwd"] == before["fir_cascade_fwd"] + 1
    assert rel(fma, ref) < TOL[precision]


def test_complex_planes(dev):
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(2, 4096 + 95) + 1j * rng.randn(2, 4096 + 95))
                         .astype(np.complex64)).to(dev)
    tc = torch.from_numpy(((rng.randn(96) + 1j * rng.randn(96)) / 96)
                          .astype(np.complex64)).to(dev)
    assert rel(cf.fir_decim_cc(x, tc, 2, precision="f32"),
               fir_filter(x, tc, 2, "f32")) < TOL["f32"]
    assert rel(cf.fir_decim_c(x, tc.real.contiguous(), 4, precision="f32"),
               fir_filter(x, tc.real.contiguous(), 4, "f32")) < TOL["f32"]


@pytest.mark.parametrize("k", [16, 515, 4097])
def test_bf16_resident_bit_identical(dev, k):
    """On both routes (K 16 takes the FMA route, the others the tensor
    cores) the bf16-resident stream gives the f32 stream's bf16 output."""
    x = randn(dev, 2, 1 << 14, seed=6)
    taps = randn(dev, k, seed=7) * 0.05
    y32 = cf.fir_cascade(x, taps, 1, precision="bf16")
    y16 = cf.fir_cascade(x.to(torch.bfloat16), taps, 1, precision="bf16")
    assert torch.equal(y32, y16)


def test_launch_counts(dev):
    before = dict(cf.launches)
    cf.fir_decim(randn(dev, 1, 800 + 32), randn(dev, 33), 8)
    cf.fir_cascade(randn(dev, 1, 512), randn(dev, 9), 3)
    cf.fir_decim_cc(torch.complex(randn(dev, 1, 64 + 8), randn(dev, 1, 72)),
                    torch.complex(randn(dev, 9), randn(dev, 9)), 2)
    cf.fir_long(randn(dev, 100 + 8), randn(dev, 9), precision="f32")
    after = {n: cf.launches[n] - before[n] for n in cf.launches}
    assert after == {"fir_tile_fwd": 1, "fir_toeplitz_fwd": 0,
                     "fir_decim_fwd": 2, "fir_decim_mma_fwd": 1,
                     "fir_cascade_fwd": 1, "fir_cascade_mma_fwd": 0,
                     "viterbi_fwd": 0, "dfe_feedback_fwd": 0}


ODD_DECIM_CASES = [
    # k, d, b, nout, lead, g, total (None: the exact window)
    (193, 8, 1, 8192, 0, 1, None),       # the WBFM chunk
    (155, 8, 5, 1000, 0, 1, None),       # nout no multiple of any tile
    (155, 8, 3, 4097, 77, 1, None),      # a lead, several tiles a block
    (40, 3, 6, 600, 39, 3, None),        # odd decimation, three tap sets
    (33, 4, 4, 5001, 7, 2, None),
    (31, 2, 2, 777, 0, 1, None),
    (64, 8, 2, 50, 500, 1, 100),         # the stream ends inside the window
    (2100, 3, 2, 500, 0, 1, None),       # long taps at an odd decimation
    (4097, 16, 2, 300, 0, 1, None),
    (17, 5, 1, 33, 0, 1, None),
]


@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("k,d,b,nout,lead,g,total", ODD_DECIM_CASES)
def test_decim_fma_route(dev, precision, k, d, b, nout, lead, g, total):
    """fir_decim_fwd (forced for the bf16 modes) against the twin at odd
    sizes, and bit-identical from a bf16-resident stream."""
    total = total or nout * d + k - 1 - lead
    x = randn(dev, b, total, seed=k)
    ts = randn(dev, g, k, seed=k + 1) / np.sqrt(k)
    before = dict(cf.launches)
    got = cf._launch_tile(x, ts, d, lead, nout, precision, _fma=True)
    torch.cuda.synchronize()
    assert cf.launches["fir_decim_fwd"] == before["fir_decim_fwd"] + 1
    ref = cf.fir_tile_ref(x, ts, d, lead, nout, precision)
    assert torch.isfinite(got).all()
    assert rel(got, ref) < TOL[precision]
    if precision == "bf16":
        got16 = cf._launch_tile(x.to(torch.bfloat16), ts, d, lead, nout,
                                precision, _fma=True)
        assert torch.equal(got, got16)


def mma_route(x, ts, d, lead, nout, precision):
    """fir_decim_mma_fwd whatever the tap count."""
    from grtpu_torch.ops._build import library

    b, total = x.shape
    g, k = ts.shape
    plan = cf._Plan("fir_decim_mma_fwd", library().fir_decim_mma_fwd,
                    (b, total, g, k, d, lead, nout,
                     cf._PRECISION_CODE[precision])
                    + cf._decim_mma_plan(precision, d, k, b, nout))
    return cf._launch_tile(x, ts, d, lead, nout, precision, _plan=plan)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("k,d,b,nout,lead,g,total", ODD_DECIM_CASES)
def test_decim_tensor_core_route(dev, precision, k, d, b, nout, lead, g,
                                 total):
    """fir_decim_mma_fwd against the twin and its own plain form at odd
    sizes, and bit-identical from a bf16-resident stream."""
    total = total or nout * d + k - 1 - lead
    x = randn(dev, b, total, seed=k)
    ts = randn(dev, g, k, seed=k + 1) / np.sqrt(k)
    before = dict(cf.launches)
    got = mma_route(x, ts, d, lead, nout, precision)
    torch.cuda.synchronize()
    assert cf.launches["fir_decim_mma_fwd"] == before["fir_decim_mma_fwd"] + 1
    assert cf.launches["fir_decim_fwd"] == before["fir_decim_fwd"]
    if cf._route(precision, d, k, b, nout) == "decim_mma":   # the call's own
        assert torch.equal(got, cf._tile(x, ts, d, lead, nout, precision))
        assert cf.launches["fir_decim_mma_fwd"] == \
            before["fir_decim_mma_fwd"] + 2
    ref = cf.fir_tile_ref(x, ts, d, lead, nout, precision)
    assert torch.isfinite(got).all()
    assert rel(got, ref) < TOL[precision]
    plain = cf.fir_decim_mma_ref(x, ts, d, lead, nout, precision)
    assert rel(got, plain) < TOL[precision]
    if precision == "bf16":
        got16 = mma_route(x.to(torch.bfloat16), ts, d, lead, nout, precision)
        assert torch.equal(got, got16)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("mtb,to,tpb", [(1, 8, 1), (1, 56, 3), (1, 128, 16),
                                        (2, 256, 2), (4, 512, 5)])
def test_decim_tensor_core_plans(dev, precision, mtb, to, tpb):
    """Every block shape of the tensor-core route gives the same outputs."""
    from grtpu_torch.ops._build import library

    k, d, b, nout = 155, 8, 3, 3000
    x = randn(dev, b, nout * d + k - 1, seed=1)
    ts = randn(dev, 1, k, seed=2) / np.sqrt(k)
    plan = cf._Plan("fir_decim_mma_fwd", library().fir_decim_mma_fwd,
                    (b, x.shape[1], 1, k, d, 0, nout,
                     cf._PRECISION_CODE[precision], mtb, to, tpb))
    got = cf._launch_tile(x, ts, d, 0, nout, precision, _plan=plan)
    ref = cf.fir_tile_ref(x, ts, d, 0, nout, precision)
    assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("precision", ["f32", "bf16x3"])
def test_decim_misaligned_stream(dev, precision):
    """A stream whose rows start at any 4-byte address: the load ring keeps
    the shift to the 16-byte boundary below each window."""
    k, d, nout = 155, 8, 1000
    total = nout * d + k - 1
    flat = randn(dev, 2 * total + 3, seed=5)
    ts = randn(dev, 1, k, seed=6) / 12
    for off in (1, 2, 3):
        x = flat[off:off + 2 * total].view(2, total)
        got = cf.fir_decim(x, ts, d, precision=precision)
        ref = cf.fir_tile_ref(x, ts, d, 0, nout, precision)
        assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("s", [2, 16])
@pytest.mark.parametrize("k", [5, 256])
@pytest.mark.parametrize("n", [128, 1 << 16])
def test_cascade_f32(dev, s, k, n):
    x = randn(dev, 3, n, seed=s)
    taps = randn(dev, k, seed=k) * (0.05 if k == 256 else 0.3)
    before = dict(cf.launches)
    got = cf.fir_cascade(x, taps, s, precision="f32")
    assert cf.launches["fir_cascade_fwd"] == before["fir_cascade_fwd"] + 1
    ref = cf.fir_cascade_ref(x, taps, s, "f32")
    assert torch.isfinite(got).all()
    assert rel(got, ref) < TOL["f32"]
    for plan in ((1024, 256), (8192, 512), (16384, 1024)):
        if cf._cascade_smem("f32", k, s, plan[0]) <= cf._SMEM_OPTIN:
            forced = cf._launch_cascade(x, taps, s, "f32", _plan=plan)
            assert rel(forced, ref) < TOL["f32"]


def test_shared_memory_sizes_match_the_library(dev):
    """The wrapper plans with its own copies of the kernels' shared-memory
    formulas; they are the library's."""
    from grtpu_torch.ops._build import library

    lib = library()
    for precision, code in cf._PRECISION_CODE.items():
        for k, d in ((155, 8), (193, 8), (33, 2), (4097, 16), (7, 5), (200, 4),
                     (40, 3)):
            for v in (1, 2, 4):
                for es in (4, 2):
                    assert lib.fir_decim_smem(code, es == 2, k, d, v) == \
                        cf._decim_smem(precision, es, k, d, v)
                    assert lib.fir_decim_mma_smem(code, es == 2, k, d, v) == \
                        cf._decim_mma_smem(precision, es, k, d, v)
        for k, s, t in ((256, 16, 16384), (5, 2, 256), (64, 3, 8192)):
            assert lib.fir_cascade_smem(code, k, s, t) == \
                cf._cascade_smem(precision, k, s, t)
        for th, d, kb in ((256, 1, 2048), (32, 8, 193), (64, 3, 2048)):
            assert lib.fir_tile_smem(code, th, d, kb) == \
                cf._tile_smem(precision, th, d, kb)


def test_wbfm_kernel_graph_matches_plain(dev):
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.blocks.analog import QuadratureDemod
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.models.fm import FmDeemph, WfmRcv
    from grtpu_torch.utils import firdes

    fs, n = 256e3, 1 << 15
    phase = np.cumsum(2 * np.pi * 75e3 / fs * 0.5
                      * np.sin(2 * np.pi * 1e3 * np.arange(n) / fs))
    iq = np.exp(1j * phase).astype(np.complex64)
    taps = firdes.low_pass(1.0, fs, fs / 16 - 1e3, fs / 80,
                           firdes.Window.HAMMING)
    outs = []
    for kernel in (True, False):
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.float32))
        if kernel:
            g.connect(pin, QuadratureDemod(fs / (2 * np.pi * 75e3)),
                      FirFilter(8, taps, "fff", impl="kernel"),
                      FmDeemph(fs / 8), pout)
        else:
            g.connect(pin, WfmRcv(fs, 8), pout)
        outs.append(StreamExecutor(g, chunk_size=8192, device=dev).run(iq))
    assert rel(outs[0], outs[1]) < TOL["bf16x3"]
