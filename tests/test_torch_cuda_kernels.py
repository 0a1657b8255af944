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
                     "fir_decim_fwd": 1, "fir_decim_mma_fwd": 1,
                     "fir_cascade_fwd": 1, "fir_cascade_mma_fwd": 0,
                     "viterbi_fwd": 0, "dfe_feedback_fwd": 0,
                     "iir1_fwd": 0, "fir_decim_cc": 1}


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
    (8193, 16, 2, 200, 0, 1, None),      # no ring: windows from memory
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


def mma_route(x, ts, d, lead, nout, precision, cplx=0, plan=None):
    """fir_decim_mma_fwd whatever the tap count (``plan``: another (mtb,
    to, tpb) than the planner's)."""
    b, total = x.shape
    g, k = ts.shape
    plan = cf._decim_launch(
        "fir_decim_mma_fwd", b, total, g, k, d, lead, nout, precision,
        plan or cf._decim_mma_plan(precision, d, k, b, nout, cplx=cplx), cplx)
    return cf._launch_tile(x, ts, d, lead, nout, precision, _plan=plan,
                           cplx=cplx)


def fma_route(x, ts, d, lead, nout, precision, cplx=0, plan=None):
    """fir_decim_fwd (``plan``: another (kp, tpb) than the planner's)."""
    b, total = x.shape
    g, k = ts.shape
    plan = cf._decim_launch(
        "fir_decim_fwd", b, total, g, k, d, lead, nout, precision,
        plan or cf._decim_fma_plan(precision, d, k, b, nout, cplx=cplx), cplx)
    return cf._launch_tile(x, ts, d, lead, nout, precision, _plan=plan,
                           cplx=cplx)


def tile_route(x, ts, d, lead, nout, precision, cplx=0, plan=None):
    """fir_tile_fwd whatever the route (``plan``: another (threads, kblk)
    than the planner's)."""
    b, total = x.shape
    g, k = ts.shape
    launch = cf._tile_launch(
        b, total, g, k, d, lead, nout, precision,
        plan or cf._tile_plan(precision, d, k, b, nout, cplx=cplx), cplx)
    return cf._launch_tile(x, ts, d, lead, nout, precision, _plan=launch,
                           cplx=cplx)


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
    k, d, b, nout = 155, 8, 3, 3000
    x = randn(dev, b, nout * d + k - 1, seed=1)
    ts = randn(dev, 1, k, seed=2) / np.sqrt(k)
    got = mma_route(x, ts, d, 0, nout, precision, plan=(mtb, to, tpb))
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
                     (40, 3), (99, 8), (96, 2), (4097, 8), (2100, 3),
                     (155, 1), (16, 1), (4097, 1), (99, 1)):
            for v in (1, 2, 4):
                for es, cplx in ((4, 0), (2, 0), (8, 1), (8, 2)):
                    assert lib.fir_decim_smem(code, es == 2, k, d, v,
                                              cplx) == \
                        cf._decim_smem(precision, es, k, d, v, cplx)
                    assert lib.fir_decim_mma_smem(code, es == 2, k, d, v,
                                                  cplx) == \
                        cf._decim_mma_smem(precision, es, k, d, v, cplx)
        for k, s, t in ((256, 16, 16384), (5, 2, 256), (64, 3, 8192)):
            assert lib.fir_cascade_smem(code, k, s, t) == \
                cf._cascade_smem(precision, k, s, t)
        for th, d, kb in ((256, 1, 2048), (32, 8, 193), (64, 3, 2048),
                          (128, 1, 155), (32, 40, 512)):
            for cplx in (0, 1, 2):
                assert lib.fir_tile_smem(code, th, d, kb, cplx) == \
                    cf._tile_smem(precision, th, d, kb, cplx)


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


# ------------------------------------------------------- the complex modes
def crandn(dev, *shape, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) + 1j * rng.randn(*shape))
                            .astype(np.complex64)).to(dev)


def complex_taps(dev, cplx, g, k, seed):
    """(G, K) float32 (ccf) or complex64 (ccc) taps, unit gain scale."""
    t = crandn(dev, g, k, seed=seed) / np.sqrt(k)
    return t.real.contiguous() if cplx == cf.CCF else t


def plane_path(x, ts, d, lead, nout, precision, cplx):
    """The real kernel over the stacked re / im planes: the path the
    complex modes replace (row r of 2B plane rows on the tap set of complex
    row r % B, so every tap set goes as it goes in the complex mode)."""
    b = x.shape[0]
    g = ts.shape[0]
    planes = torch.cat([x.real, x.imag]).contiguous()
    per_row = ts[torch.arange(b, device=x.device) % g]

    def real(t):
        return cf._tile(planes, t.contiguous(), d, lead, nout, precision)

    if cplx == cf.CCF:
        y = real(per_row)
        return torch.complex(y[:b], y[b:])
    yr, yi = real(per_row.real), real(per_row.imag)
    return torch.complex(yr[:b] - yi[b:], yi[:b] + yr[b:])


COMPLEX_CASES = [
    # k, d, b, nout, lead, g, total (None: the exact window)
    (155, 8, 3, 4097, 0, 1, None),        # several tiles, a ragged last one
    (193, 8, 1, 8192, 0, 1, None),        # a lone chunk
    (99, 8, 2, 1001, 98, 2, None),        # a lead, two complex tap sets
    (99, 8, 3, 1001, 98, 2, None),        # channel 2 on set 0: G does not
                                          # divide the channels
    (33, 2, 4, 777, 7, 2, None),
    (40, 3, 3, 600, 39, 3, None),         # odd decimation, three tap sets
    (64, 4, 2, 1000, 0, 1, 4000 + 63 + 2),  # odd row length: 8-byte rows
    (17, 5, 2, 333, 3, 1, None),          # a decimation with no template
    (64, 8, 2, 50, 500, 1, 100),          # the stream ends inside a window
    (96, 2, 4, 8192, 0, 1, None),         # the 4 x 8k cc case
    (4097, 16, 2, 300, 0, 1, None),       # no ring: windows from memory
    # decimation 1: a tile of the tensor-core route is 128 consecutive
    # outputs; fir_tile_fwd's complex mode
    (155, 1, 3, 4097, 0, 1, None),        # several tiles, a ragged last one
    (99, 1, 3, 1001, 98, 2, None),        # a lead, G does not divide C
    (64, 1, 2, 1000, 0, 1, 1000 + 63 + 1),  # odd row length: 8-byte rows
    (17, 1, 2, 50, 3, 1, 30),             # the stream ends inside a window
    (16, 1, 1, 8192, 0, 1, None),         # a lone chunk, the shortest taps
    (4097, 1, 2, 300, 0, 1, None),        # long taps: kblk blocks, no ring
]


def complex_params():
    """(case, precision, route, cplx) for every forced route that has a
    plan at the case's shape (the bf16x3 FMA route's ccc planes do not fit
    at 4097 taps and decimation 16; that call takes the tensor cores)."""
    out = []
    for case in COMPLEX_CASES:
        k, d, b, nout = case[:4]
        for precision, route in (("f32", "fma"), ("bf16x3", "fma"),
                                 ("bf16", "fma"), ("bf16x3", "mma"),
                                 ("bf16", "mma"), ("f32", "tile"),
                                 ("bf16x3", "tile"), ("bf16", "tile")):
            planner = {"mma": cf._decim_mma_plan, "fma": cf._decim_fma_plan,
                       "tile": cf._tile_plan}[route]
            for cplx in (1, 2):
                if planner(precision, d, k, b, nout, cplx=cplx) is not None:
                    out.append(case + (precision, route, cplx))
    return out


@pytest.mark.parametrize("k,d,b,nout,lead,g,total,precision,route,cplx",
                         complex_params())
def test_complex_modes(dev, precision, route, cplx, k, d, b, nout, lead, g,
                       total):
    """Both decimating kernels and fir_tile_fwd in both complex modes
    against their plain form and against the real kernel over the stacked
    planes, at odd sizes and at decimation 1: one launch, the interleaved
    complex64 stream in and out."""
    total = total or nout * d + k - 1 - lead
    x = crandn(dev, b, total, seed=k + d)
    ts = complex_taps(dev, cplx, g, k, seed=k + 1)
    fn = {"mma": mma_route, "fma": fma_route, "tile": tile_route}[route]
    name = {"mma": "fir_decim_mma_fwd", "fma": "fir_decim_fwd",
            "tile": "fir_tile_fwd"}[route]
    before = dict(cf.launches)
    got = fn(x, ts, d, lead, nout, precision, cplx)
    torch.cuda.synchronize()
    assert {n: cf.launches[n] - before[n] for n in cf.launches
            if cf.launches[n] != before[n]} == {name: 1}
    assert got.dtype == torch.complex64 and got.shape == (b, nout)
    assert torch.isfinite(torch.view_as_real(got)).all()
    ref = cf.fir_decim_cplx_ref(x, ts, d, lead, nout, precision, cplx)
    assert rel(got, ref) < TOL[precision]
    assert rel(got, plane_path(x, ts, d, lead, nout, precision, cplx)) < \
        TOL[precision]


@pytest.mark.parametrize("cplx", [1, 2])
@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
@pytest.mark.parametrize("plan", [(1, 8, 1), (1, 56, 3), (1, 128, 16),
                                  (2, 256, 2), (4, 512, 5)])
def test_complex_tensor_core_plans(dev, precision, cplx, plan):
    """Every block shape (mtb, to, tpb) of the tensor-core route gives the
    same outputs in the complex modes."""
    k, d, b, nout = 155, 8, 3, 3000
    x = crandn(dev, b, nout * d + k - 1, seed=1)
    ts = complex_taps(dev, cplx, 2, k, seed=2)
    got = mma_route(x, ts, d, 0, nout, precision, cplx, plan)
    ref = cf.fir_decim_cplx_ref(x, ts, d, 0, nout, precision, cplx)
    assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("cplx", [1, 2])
@pytest.mark.parametrize("precision", ["f32", "bf16x3"])
@pytest.mark.parametrize("plan", [(4, 1), (4, 7), (2, 3), (1, 1), (1, 16)])
def test_complex_fma_plans(dev, precision, cplx, plan):
    """Every (kp, tpb) of the FMA route gives the same outputs in the
    complex modes."""
    k, d, b, nout = 155, 8, 3, 3000
    x = crandn(dev, b, nout * d + k - 1, seed=3)
    ts = complex_taps(dev, cplx, 2, k, seed=4)
    got = fma_route(x, ts, d, 0, nout, precision, cplx, plan)
    ref = cf.fir_decim_cplx_ref(x, ts, d, 0, nout, precision, cplx)
    assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("cplx", [1, 2])
@pytest.mark.parametrize("precision", ["f32", "bf16x3"])
@pytest.mark.parametrize("plan", [(256, 2048), (32, 64), (128, 8), (64, 513)])
def test_complex_tile_plans(dev, precision, cplx, plan):
    """Every (threads, kblk) of fir_tile_fwd gives the same outputs in the
    complex modes, several passes of taps among them, at decimation 1 and
    3."""
    k, b, nout = 155, 3, 3000
    ts = complex_taps(dev, cplx, 2, k, seed=6)
    for d in (1, 3):
        x = crandn(dev, b, nout * d + k - 1, seed=5 + d)
        got = tile_route(x, ts, d, 7, nout, precision, cplx, plan)
        ref = cf.fir_decim_cplx_ref(x, ts, d, 7, nout, precision, cplx)
        assert rel(got, ref) < TOL[precision]


@pytest.mark.parametrize("sig", ["ccf", "ccc"])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_complex_wrappers_one_launch(dev, sig, d):
    """fir_decim_c / fir_decim_cc on the card: one launch of the route
    _route names, no copy of contiguous taps on the device, numpy taps and
    a misaligned view of the stream alike; at decimation 1 in every
    precision, a short stream too."""
    k, c, n = 96, 4, 2048
    flat = crandn(dev, c * (n * d + k - 1) + 1, seed=d)
    x = flat[1:].view(c, n * d + k - 1)       # rows start 8 bytes off
    cplx = cf.CCF if sig == "ccf" else cf.CCC
    ts = complex_taps(dev, cplx, 1, k, seed=5)[0]
    fn = cf.fir_decim_c if sig == "ccf" else cf.fir_decim_cc
    route = cf._route("bf16x3", d, k, c, n, cplx=cplx)
    name = "fir_decim_mma_fwd" if route == "decim_mma" else "fir_decim_fwd"
    # a ccc call's launch is counted under fir_decim_cc too
    mode = {"fir_decim_cc": 1} if cplx == cf.CCC else {}
    before = dict(cf.launches)
    got = fn(x, ts, d)
    assert {nm: cf.launches[nm] - before[nm] for nm in cf.launches
            if cf.launches[nm] != before[nm]} == {name: 1, **mode}
    assert torch.equal(fn(x, ts.cpu().numpy(), d), got)
    ref = cf.fir_decim_cplx_ref(x, ts, d, 0, n, "bf16x3", cplx)
    assert rel(got, ref) < TOL["bf16x3"]
    assert cf._complex_taps(ts, x.device, cplx) is ts
    for precision in ("f32", "bf16", "bf16x3"):
        for nn in (n, 5):
            xs = x[:, :nn + k - 1]
            route = cf._route(precision, 1, k, c, nn, cplx=cplx)
            name = {"decim_mma": "fir_decim_mma_fwd",
                    "decim_fma": "fir_decim_fwd"}[route]
            before = dict(cf.launches)
            y1 = fn(xs, ts, 1, precision=precision)
            assert {nm: cf.launches[nm] - before[nm] for nm in cf.launches
                    if cf.launches[nm] != before[nm]} == {name: 1, **mode}
            assert rel(y1, cf.fir_decim_cplx_ref(
                xs, ts, 1, 0, nn, precision, cplx)) < TOL[precision]
            assert torch.equal(fn(xs, ts.cpu().numpy(), 1,
                                  precision=precision), y1)


@pytest.mark.parametrize("sig", ["ccf", "ccc"])
@pytest.mark.parametrize("precision", ["f32", "bf16x3"])
@pytest.mark.parametrize("k,d,c,g,n", [(155, 1, 5, 3, 3000),
                                       (16385, 16, 3, 2, 40)])
def test_complex_wrappers_planes_tapsets(dev, sig, precision, k, d, c, g, n):
    """fir_decim_c / fir_decim_cc at the shapes that took the "planes" route
    until decimation 1 and oversized windows had complex launches of their
    own (decimation 1, and a window no decimating plan fits), with (G, K)
    taps where G does not divide the channels: one launch of the route
    _route names, channel c on set c % G for both planes, as the planes
    path (forced) gives it, numpy taps alike."""
    cplx = cf.CCF if sig == "ccf" else cf.CCC
    route = cf._route(precision, d, k, c, n, cplx=cplx)
    name = {"decim_mma": "fir_decim_mma_fwd", "decim_fma": "fir_decim_fwd",
            "tile": "fir_tile_fwd"}[route]
    x = crandn(dev, c, n * d + k - 1, seed=k + c)
    ts = complex_taps(dev, cplx, g, k, seed=k + g)
    fn = cf.fir_decim_c if sig == "ccf" else cf.fir_decim_cc
    mode = {"fir_decim_cc": 1} if cplx == cf.CCC else {}
    before = dict(cf.launches)
    got = fn(x, ts, d, precision=precision)
    torch.cuda.synchronize()
    assert {nm: cf.launches[nm] - before[nm] for nm in cf.launches
            if cf.launches[nm] != before[nm]} == {name: 1, **mode}
    assert got.dtype == torch.complex64 and got.shape == (c, n)
    forced = cf._decim_complex(x, ts, d, precision, cplx,
                               _force_planes=True)
    assert rel(got, forced) < TOL[precision]
    ref = cf.fir_decim_cplx_ref(x, ts, d, 0, n, precision, cplx)
    assert rel(got, ref) < TOL[precision]
    assert rel(got, plane_path(x, ts, d, 0, n, precision, cplx)) < \
        TOL[precision]
    assert torch.equal(fn(x, ts.cpu().numpy(), d, precision=precision), got)


@pytest.mark.parametrize("sig", ["ccf", "ccc"])
@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_complex_long_taps_take_the_planes(dev, sig, precision):
    """At decimation 1 the bf16 modes' long filters take the stacked planes
    on fir_toeplitz_fwd, which measured faster there (one launch a tap
    plane), with G not dividing the channels; the one-launch tensor-core
    route gives the same outputs."""
    cplx = cf.CCF if sig == "ccf" else cf.CCC
    k, c, g, n = cf._D1_PLANES_TAPS[cplx], 3, 2, 3000
    assert cf._route(precision, 1, k, c, n, cplx=cplx) == "planes"
    x = crandn(dev, c, n + k - 1, seed=k)
    ts = complex_taps(dev, cplx, g, k, seed=k + 1)
    fn = cf.fir_decim_c if sig == "ccf" else cf.fir_decim_cc
    before = dict(cf.launches)
    got = fn(x, ts, 1, precision=precision)
    torch.cuda.synchronize()
    assert {nm: cf.launches[nm] - before[nm] for nm in cf.launches
            if cf.launches[nm] != before[nm]} == {
                "fir_toeplitz_fwd": 1 if cplx == cf.CCF else 2}
    ref = cf.fir_decim_cplx_ref(x, ts, 1, 0, n, precision, cplx)
    assert rel(got, ref) < TOL[precision]
    assert rel(mma_route(x, ts, 1, 0, n, precision, cplx), ref) < \
        TOL[precision]


def test_complex_modes_refuse_a_bf16_stream(dev):
    """The C entries (fir_tile_fwd's too) refuse a complex mode on a bf16
    stream, and a mode they do not know, instead of computing something
    else."""
    from grtpu_torch.ops._build import library

    lib = library()
    x = torch.zeros(1, 100, dtype=torch.bfloat16, device=dev)
    y = torch.empty(1, 20, dtype=torch.complex64, device=dev)
    t = torch.zeros(1, 9, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for cplx in (1, 2, 3, -1):
        assert lib.fir_decim_fwd(x.data_ptr(), 1, t.data_ptr(), y.data_ptr(),
                                 1, 100, 1, 9, 4, 0, 20, 1, 4, 1, cplx,
                                 stream) != 0
        assert lib.fir_decim_mma_fwd(x.data_ptr(), 1, t.data_ptr(),
                                     y.data_ptr(), 1, 100, 1, 9, 4, 0, 20, 1,
                                     1, 8, 1, cplx, stream) != 0
        assert lib.fir_tile_fwd(x.data_ptr(), 1, t.data_ptr(), y.data_ptr(),
                                1, 100, 1, 9, 1, 0, 20, 1, 32, 9, cplx,
                                stream) != 0
    for cplx in (3, -1):
        assert lib.fir_decim_fwd(y.data_ptr(), 0, t.data_ptr(), y.data_ptr(),
                                 1, 20, 1, 9, 4, 0, 2, 0, 4, 1, cplx,
                                 stream) != 0
        assert lib.fir_tile_fwd(y.data_ptr(), 0, t.data_ptr(), y.data_ptr(),
                                1, 20, 1, 9, 1, 0, 12, 0, 32, 9, cplx,
                                stream) != 0


@pytest.mark.parametrize("decim", [8, 1])
def test_firfilter_ccc_graph(dev, decim):
    """FirFilter("ccc", impl="kernel") in a graph, decimating and at
    decimation 1: one fir_decim_mma_fwd launch a chunk in both run modes,
    counted under fir_decim_cc too, device_loop torch.equal to eager, and
    within bf16x3's tolerance of impl="mxu"."""
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.ops.fir import rotate_taps
    from grtpu_torch.utils import firdes

    fs, chunk, nchunks = 2.048e6, 16384, 4
    taps = rotate_taps(firdes.low_pass(1.0, fs, 100e3, 50e3), 400e3, fs)
    x = crandn(dev, chunk * nchunks, seed=9)

    def run(impl, device_loop=False):
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.complex64))
        g.connect(pin, FirFilter(decim, taps, "ccc", impl=impl), pout)
        ex = StreamExecutor(g, chunk_size=chunk, device=dev)
        for name in cf.launches:
            cf.launches[name] = 0
        y = ex.run(x, device_loop=device_loop)
        torch.cuda.synchronize()
        return y, dict(cf.launches)

    eager, n_eager = run("kernel")
    loop, n_loop = run("kernel", True)
    assert torch.equal(eager, loop)
    for n in (n_eager, n_loop):
        assert sum(n.values()) == 2 * nchunks
        assert n["fir_decim_mma_fwd"] == n["fir_decim_cc"] == nchunks
    mxu, n_mxu = run("mxu")
    assert sum(n_mxu.values()) == 0
    assert rel(eager, mxu) < TOL["bf16x3"]
