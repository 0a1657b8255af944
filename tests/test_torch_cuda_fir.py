"""grtpu_torch.ops.cuda_fir held against grtpu.ops.pallas_fir on the CPU.

On a CPU tensor every cuda_fir function runs its kernel's plain PyTorch
twin; grtpu's Pallas kernel runs in interpret mode, as grtpu's own tests
run it.  The shapes and precisions are those of tests/test_fir.py:315-636,
with local seeds.  Tolerances (max|port - grtpu| / max|grtpu|) are grtpu's:
f32 < 1e-5, bf16x3 < 1e-4, bf16 < 3e-2.  The kernels themselves are held
against the twins on the card by tests/test_torch_cuda_kernels.py and
chip_smoke.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grtpu.ops import pallas_fir as jpf  # noqa: E402
from grtpu.ops.fir import fir_filter as jfir  # noqa: E402
from grtpu_torch.ops import cuda_fir as cf  # noqa: E402
from grtpu_torch.ops.fir import compose_taps_power  # noqa: E402

TOL = {"f32": 1e-5, "bf16x3": 1e-4, "bf16": 3e-2}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestCascade:
    @pytest.mark.parametrize("k,nst,tile", [(256, 16, 8), (256, 2, 16),
                                            (64, 5, 8), (17, 1, 8)])
    def test_vs_pallas(self, k, nst, tile):
        rng = np.random.RandomState(k + nst)
        x = rng.randn(2, 1024).astype(np.float32)
        taps = (rng.randn(k) * 0.1).astype(np.float32)
        ref = np.asarray(jpf.fir_cascade(jnp.asarray(x), taps, nst,
                                         tile_rows=tile, interpret=True))
        got = cf.fir_cascade(T(x), taps, nst).numpy()
        assert got.dtype == np.float32
        assert rel(got, ref) < TOL["f32"]

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    def test_multistage_split_precisions(self, precision):
        rng = np.random.RandomState(21)
        x = rng.randn(2, 512).astype(np.float32)
        taps = (rng.randn(64) * 0.1).astype(np.float32)
        ref = np.asarray(jpf.fir_cascade(jnp.asarray(x), taps, 3, tile_rows=8,
                                         interpret=True, precision=precision))
        got = cf.fir_cascade(T(x), taps, 3, precision=precision).numpy()
        assert rel(got, ref) < TOL[precision]

    def test_1d_input(self):
        rng = np.random.RandomState(22)
        x = rng.randn(512).astype(np.float32)
        taps = (rng.randn(32) * 0.2).astype(np.float32)
        ref = np.asarray(jpf.fir_cascade(jnp.asarray(x), taps, 1, tile_rows=8,
                                         interpret=True))
        got = cf.fir_cascade(T(x), taps, 1).numpy()
        assert got.shape == (512,)
        assert rel(got, ref) < TOL["f32"]

    def test_long_filter_matches_numpy(self):
        rng = np.random.RandomState(3)
        taps = (rng.randn(1000) * 0.03).astype(np.float32)
        x = rng.randn(2, 1536).astype(np.float32)
        ref = np.stack([
            np.convolve(np.concatenate([np.zeros(len(taps) - 1), xi]),
                        taps, "valid") for xi in x])
        got = cf.fir_cascade(T(x), taps, 1, precision="f32").numpy()
        assert rel(got, ref) < TOL["f32"]

    def test_composed_equals_cascade(self):
        rng = np.random.RandomState(4)
        taps = (rng.randn(64) * 0.1).astype(np.float32)
        comp = compose_taps_power(taps, 4)
        x = rng.randn(1, 1024).astype(np.float32)
        y_cas = cf.fir_cascade(T(x), taps, 4, precision="f32").numpy()
        y_cmp = cf.fir_cascade(T(x), comp, 1, precision="f32").numpy()
        assert rel(y_cmp, y_cas) < TOL["f32"]
        ref = np.asarray(jpf.fir_cascade(jnp.asarray(x), comp, 1,
                                         tile_rows=256, interpret=True,
                                         precision="f32"))
        assert rel(y_cmp, ref) < TOL["f32"]

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    def test_single_stage_bf16_paths(self, precision):
        rng = np.random.RandomState(5)
        taps = (rng.randn(300) * 0.05).astype(np.float32)
        x = rng.randn(1, 1024).astype(np.float32)
        ref = np.asarray(jpf.fir_cascade(jnp.asarray(x), taps, 1,
                                         tile_rows=256, interpret=True,
                                         precision=precision))
        got = cf.fir_cascade(T(x), taps, 1, precision=precision).numpy()
        assert rel(got, ref) < TOL[precision]

    def test_length_must_be_lane_multiple(self):
        with pytest.raises(ValueError, match="multiple of 128"):
            cf.fir_cascade(torch.zeros(1, 200), np.ones(5, np.float32), 2)


class TestBf16Resident:
    def test_bit_identical_to_f32_input(self):
        rng = np.random.RandomState(6)
        taps = (rng.randn(515) * 0.05).astype(np.float32)
        x = rng.randn(2, 4096).astype(np.float32)
        y32 = cf.fir_cascade(T(x), taps, 1, precision="bf16")
        y16 = cf.fir_cascade(T(x).to(torch.bfloat16), taps, 1,
                             precision="bf16")
        assert y16.dtype == torch.float32
        assert torch.equal(y32, y16)
        ref = np.asarray(jpf.fir_cascade(
            jnp.asarray(x).astype(jnp.bfloat16), taps, 1, tile_rows=256,
            precision="bf16", interpret=True))
        assert rel(y16.numpy(), ref) < TOL["bf16"]

    @pytest.mark.parametrize("nstages,precision", [(1, "bf16x3"), (2, "bf16"),
                                                   (1, "f32")])
    def test_guards(self, nstages, precision):
        x16 = torch.randn(1, 512).to(torch.bfloat16)
        with pytest.raises(ValueError):
            cf.fir_cascade(x16, np.ones(65, np.float32), nstages,
                           precision=precision)

    def test_decim_guard(self):
        x16 = torch.randn(1, 512 + 30).to(torch.bfloat16)
        with pytest.raises(ValueError):
            cf.fir_decim(x16, np.ones(31, np.float32), 2, precision="bf16x3")


class TestFlowgraphEntryPoints:
    def test_fir_long_matches_pallas(self):
        rng = np.random.RandomState(9)
        taps = (rng.randn(700) * 0.02).astype(np.float32)
        x = rng.randn(1500 + 699).astype(np.float32)
        ref = np.asarray(jpf.fir_long(jnp.asarray(x), taps, tile_rows=256,
                                      interpret=True, precision="f32"))
        got = cf.fir_long(T(x), taps, precision="f32").numpy()
        assert rel(got, ref) < TOL["f32"]

    @pytest.mark.parametrize("precision", ["f32", "bf16x3"])
    def test_batch_fir_long_matches_pallas(self, precision):
        rng = np.random.RandomState(10)
        taps = (rng.randn(129) * 0.05).astype(np.float32)
        x = rng.randn(3, 640 + 128).astype(np.float32)
        ref = np.asarray(jpf.batch_fir_long(jnp.asarray(x), taps,
                                            interpret=True,
                                            precision=precision))
        got = cf.batch_fir_long(T(x), taps, precision=precision).numpy()
        assert rel(got, ref) < TOL[precision]


class TestDecim:
    @pytest.mark.parametrize("k,d", [(31, 2), (155, 8), (256, 4), (129, 1)])
    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    def test_fff_decim(self, k, d, precision):
        rng = np.random.RandomState(k * d)
        n = 512 * d if d > 1 else 512
        x = rng.randn(n + k - 1).astype(np.float32)
        taps = (rng.randn(k) / k).astype(np.float32)
        ref = np.asarray(jpf.fir_decim(jnp.asarray(x), taps, d,
                                       interpret=True, precision=precision))
        got = cf.fir_decim(T(x), taps, d, precision=precision).numpy()
        assert rel(got, ref) < TOL[precision]

    def test_ccf_decim(self):
        rng = np.random.RandomState(12)
        k, d, n = 200, 4, 1024
        x = (rng.randn(n + k - 1) + 1j * rng.randn(n + k - 1)).astype(
            np.complex64)
        taps = (rng.randn(k) / k).astype(np.float32)
        ref = np.asarray(jpf.fir_decim_c(jnp.asarray(x), taps, d,
                                         interpret=True, precision="f32"))
        got = cf.fir_decim_c(T(x), taps, d, precision="f32").numpy()
        assert got.dtype == np.complex64
        assert rel(got, ref) < TOL["f32"]

    def test_ccc_decim(self):
        rng = np.random.RandomState(13)
        k, d, n = 96, 2, 512
        x = (rng.randn(n + k - 1) + 1j * rng.randn(n + k - 1)).astype(
            np.complex64)
        taps = ((rng.randn(k) + 1j * rng.randn(k)) / k).astype(np.complex64)
        ref = np.asarray(jpf.fir_decim_cc(jnp.asarray(x), taps, d,
                                          interpret=True, precision="f32"))
        got = cf.fir_decim_cc(T(x), taps, d, precision="f32").numpy()
        assert got.dtype == np.complex64
        assert rel(got, ref) < TOL["f32"]
        got_t = cf.fir_decim_cc(T(x), T(taps), d, precision="f32").numpy()
        assert rel(got_t, ref) < TOL["f32"]

    @pytest.mark.parametrize("sig,d", [("ccf", 1), ("ccc", 1), ("ccf", 8),
                                       ("ccc", 3)])
    def test_complex_wrappers_on_the_cpu(self, sig, d):
        """A CPU tensor runs the plain twin on the stacked planes at any
        decimation and launches nothing; the (K,) taps may be numpy or a
        tensor, and a ccc call with real taps equals the ccf call."""
        rng = np.random.RandomState(70 + d)
        k, c, n = 40, 3, 96
        x = (rng.randn(c, n * d + k - 1)
             + 1j * rng.randn(c, n * d + k - 1)).astype(np.complex64)
        tr = (rng.randn(k) / k).astype(np.float32)
        taps = tr if sig == "ccf" else (
            tr + 1j * rng.randn(k) / k).astype(np.complex64)
        fn = cf.fir_decim_c if sig == "ccf" else cf.fir_decim_cc
        before = dict(cf.launches)
        got = fn(T(x), taps, d, precision="f32")
        assert cf.launches == before
        assert got.shape == (c, n) and got.dtype == torch.complex64
        ref = cf.fir_decim_cplx_ref(T(x), T(taps), d, 0, n, "f32",
                                    cf.CCF if sig == "ccf" else cf.CCC)
        assert rel(got.numpy(), ref.numpy()) < TOL["f32"]
        assert torch.equal(fn(T(x), T(taps), d, precision="f32"), got)
        one = fn(T(x[0]), taps, d, precision="f32")
        assert one.shape == (n,) and rel(one.numpy(), got[0].numpy()) < 1e-6
        if sig == "ccc":
            assert torch.equal(
                cf.fir_decim_cc(T(x), T(tr), d, precision="f32"),
                cf.fir_decim_c(T(x), tr, d, precision="f32"))

    @pytest.mark.parametrize("precision", ["f32", "bf16x3"])
    @pytest.mark.parametrize("g,c,d", [(2, 3, 1), (2, 3, 3), (3, 5, 1),
                                       (3, 5, 3), (3, 6, 1), (2, 4, 3)])
    def test_complex_tapsets_per_channel(self, g, c, d, precision):
        """(G, K) taps on a complex stream: channel c takes set c % G for
        both its re and im planes, where C is no multiple of G too.  Held
        against a per-row float64 sum and against fir_decim_cplx_ref, for
        ccf and ccc, numpy taps (complex128 for ccc) and tensor taps."""
        rng = np.random.RandomState(100 * g + 10 * c + d)
        k, n = 37, 96
        x = (rng.randn(c, n * d + k - 1)
             + 1j * rng.randn(c, n * d + k - 1)).astype(np.complex64)
        tr = rng.randn(g, k) / np.sqrt(k)
        for fn, cplx, taps in (
                (cf.fir_decim_c, cf.CCF, tr.astype(np.float32)),
                (cf.fir_decim_cc, cf.CCC,
                 tr + 1j * rng.randn(g, k) / np.sqrt(k))):
            xd = x.astype(np.complex128)
            want = np.array([[np.dot(taps[r % g][::-1], xd[r, i * d:i * d + k])
                              for i in range(n)] for r in range(c)])
            tt = T(taps.astype(np.complex64 if cplx == cf.CCC
                               else np.float32))
            ref = cf.fir_decim_cplx_ref(T(x), tt, d, 0, n, precision, cplx)
            for arg in (taps, tt):
                got = fn(T(x), arg, d, precision=precision)
                assert got.shape == (c, n) and got.dtype == torch.complex64
                assert rel(got.numpy(), want) < TOL[precision]
                assert rel(got.numpy(), ref.numpy()) < TOL[precision]

    def test_complex_wrappers_check_their_input(self):
        with pytest.raises(TypeError, match="complex64"):
            cf.fir_decim_c(torch.zeros(1, 100), np.ones(5, np.float32), 4)
        with pytest.raises(ValueError, match="multiple of decim"):
            cf.fir_decim_cc(torch.zeros(1, 100 + 4, dtype=torch.complex64),
                            np.ones(5, np.complex64), 8)

    def test_batch_channels(self):
        rng = np.random.RandomState(14)
        k, d, c, n = 64, 8, 3, 2048
        x = rng.randn(c, n + k - 1).astype(np.float32)
        taps = (rng.randn(k) / k).astype(np.float32)
        ref = np.asarray(jpf.fir_decim(jnp.asarray(x), taps, d,
                                       interpret=True, precision="f32"))
        got = cf.fir_decim(T(x), taps, d, precision="f32").numpy()
        assert rel(got, ref) < TOL["f32"]
        # and the same against grtpu's plain FIR, channel by channel
        plain = np.stack([np.asarray(jfir(jnp.asarray(x[i]),
                                          jnp.asarray(taps), d))
                          for i in range(c)])
        assert rel(got, plain) < TOL["f32"]

    def test_fresh_input_must_divide(self):
        with pytest.raises(ValueError, match="multiple of decim"):
            cf.fir_decim(torch.zeros(100 + 30), np.ones(31, np.float32), 8)

    @pytest.mark.parametrize("k,d", [(155, 8), (31, 2), (7, 3), (1, 1)])
    def test_phase_split_taps_identical(self, k, d):
        taps = np.random.RandomState(k).randn(k).astype(np.float32)
        np.testing.assert_array_equal(jpf._phase_split_taps(taps, d),
                                      cf._phase_split_taps(taps, d))


class TestTileTwin:
    """The kernel twins' own contract, independent of grtpu."""

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    def test_tapset_per_row(self, precision):
        """Row b uses tap set b % G, with a decimation stride and a lead."""
        rng = np.random.RandomState(15)
        g, k, d, lead, nout = 3, 17, 2, 5, 40
        x = rng.randn(6, 100).astype(np.float32)
        ts = rng.randn(g, k).astype(np.float32)
        got = cf.fir_tile_ref(T(x), T(ts), d, lead, nout, precision).numpy()
        xp = np.concatenate([np.zeros((6, lead), np.float32), x,
                             np.zeros((6, 200), np.float32)], axis=1)
        ref = np.array([[np.dot(ts[b % g][::-1], xp[b, i * d:i * d + k])
                         for i in range(nout)] for b in range(6)])
        assert rel(got, ref) < TOL[precision]

    def test_cpu_path_launches_nothing(self):
        before = dict(cf.launches)
        cf.fir_decim(torch.randn(2, 64 + 8), np.ones(9, np.float32), 8)
        cf.fir_cascade(torch.randn(1, 256), np.ones(9, np.float32), 3)
        assert cf.launches == before

    def test_other_devices_raise(self):
        """No silent fallback: a tensor on neither CPU nor CUDA raises."""
        x = torch.empty(1, 100, device="meta")
        with pytest.raises(ValueError, match="no FIR kernel"):
            cf.fir_decim(x, np.ones(5, np.float32), 4)


class TestToeplitzRoute:
    """The plain form of the tensor-core route (rows of the stream against
    the Toeplitz matrix of the taps, hi/lo split as the kernel splits) held
    against the twin and against grtpu's Pallas kernel in interpret mode."""

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    @pytest.mark.parametrize("g", [1, 3])
    @pytest.mark.parametrize("zero_lead", [True, False])
    @pytest.mark.parametrize("k", [16, 96, 256, 513])
    def test_vs_twin(self, k, zero_lead, g, precision):
        """Ragged shapes: a stream shorter than one 128-sample row and one
        that is no multiple of it, lead 0 and K-1, row b on tap set b % G."""
        lead = k - 1 if zero_lead else 0
        rng = np.random.RandomState(k + 7 * g + lead)
        ts = T((rng.randn(g, k) / np.sqrt(k)).astype(np.float32))
        for b, nout in ((g, 77), (2 * g, 128 * 3 + 41)):
            x = T(rng.randn(b, nout + k - 1 - lead).astype(np.float32))
            got = cf.fir_toeplitz_ref(x, ts, lead, nout, precision)
            ref = cf.fir_tile_ref(x, ts, 1, lead, nout, precision)
            assert got.shape == (b, nout)
            assert rel(got.numpy(), ref.numpy()) < TOL[precision]

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    @pytest.mark.parametrize("k", [16, 96, 256, 513])
    def test_vs_pallas_fir_long(self, k, precision):
        rng = np.random.RandomState(100 + k)
        taps = (rng.randn(k) / np.sqrt(k)).astype(np.float32)
        x = rng.randn(128 * 5 + 9 + k - 1).astype(np.float32)
        ref = np.asarray(jpf.fir_long(jnp.asarray(x), taps, tile_rows=256,
                                      interpret=True, precision=precision))
        got = cf.fir_toeplitz_ref(T(x)[None], T(taps)[None], 0,
                                  len(x) - (k - 1), precision)[0].numpy()
        assert rel(got, ref) < TOL[precision]

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    @pytest.mark.parametrize("k", [16, 96, 256, 513])
    def test_vs_pallas_cascade_one_stage(self, k, precision):
        rng = np.random.RandomState(200 + k)
        taps = (rng.randn(k) / np.sqrt(k)).astype(np.float32)
        x = rng.randn(2, 1024).astype(np.float32)
        ref = np.asarray(jpf.fir_cascade(jnp.asarray(x), taps, 1,
                                         tile_rows=256, interpret=True,
                                         precision=precision))
        got = cf.fir_toeplitz_ref(T(x), T(taps)[None], k - 1, 1024,
                                  precision).numpy()
        assert rel(got, ref) < TOL[precision]

    def test_bf16_resident_input(self):
        """A bfloat16 stream gives what the float32 stream gives at bf16."""
        rng = np.random.RandomState(31)
        x = T(rng.randn(2, 700).astype(np.float32))
        ts = T((rng.randn(1, 130) * 0.1).astype(np.float32))
        y32 = cf.fir_toeplitz_ref(x, ts, 129, 700, "bf16")
        y16 = cf.fir_toeplitz_ref(x.to(torch.bfloat16), ts, 129, 700, "bf16")
        assert torch.equal(y32, y16)

    @pytest.mark.parametrize("k", [1, 2, 129, 130, 4097])
    def test_toeplitz_taps(self, k):
        """T[j, c] = taps[K-1 - (j - c)], zero where that is no tap."""
        taps = np.random.RandomState(k).randn(k).astype(np.float32)
        t = cf.toeplitz_taps(T(taps)).numpy()
        nh = -(-(k + 127) // 128)
        assert t.shape == (nh * 128, 128)
        for j, c in ((0, 0), (k - 1, 0), (k, 0), (127, 127), (k + 126, 127),
                     (5, 9), (nh * 128 - 1, 127)):
            m = j - c
            want = taps[k - 1 - m] if 0 <= m < k else 0.0
            assert t[j, c] == want, (j, c)

    @pytest.mark.parametrize("b,nout,k", [(16, 1 << 20, 4097), (1, 65536, 193),
                                          (1, 77, 16), (300, 5000, 256),
                                          (2, 128 * 129, 513)])
    def test_plan(self, b, nout, k):
        """Segments cover every output row, are whole passes, and the staged
        rows cover the last segment's last read."""
        nh, seg_rows, nseg, lrows = cf._toeplitz_plan(b, nout, k)
        rows = -(-nout // 128)
        assert nh * 128 >= k + 127 > (nh - 1) * 128
        assert seg_rows % cf._TZ_PASS_ROWS == 0 and seg_rows > 0
        assert (nseg - 1) * seg_rows < rows <= nseg * seg_rows
        assert lrows == nseg * seg_rows + nh - 1
        # about two blocks an SM, never more segments than passes
        assert nseg <= max(1, 2 * cf._H100_SMS // b)

    @pytest.mark.parametrize("n,k,s,want", [(1 << 20, 256, 16, 12288),
                                            (384, 64, 2, 384),
                                            (1 << 20, 4097, 4, 0),
                                            (128 * 77, 17, 5, 128 * 77)])
    def test_cascade_tile(self, n, k, s, want):
        assert cf._cascade_mma_tile(n, k, s) == want

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    def test_longest_filter_on_the_tensor_cores(self, precision):
        """_TZ_MAX_TAPS is the last filter length whose tap words and ring
        fit the shared memory a block may opt into; one tap more takes the
        FMA route.  The headline 4097 taps fit in both modes."""
        k = cf._TZ_MAX_TAPS[precision]
        assert cf._toeplitz_smem(precision, k) <= cf._SMEM_OPTIN
        assert cf._toeplitz_smem(precision, k + 1) > cf._SMEM_OPTIN
        assert cf._TZ_MIN_TAPS <= 4097 <= k
        assert cf._TZ_MAX_TAPS == {"bf16": 20481, "bf16x3": 6145}


class TestDecimTensorRoute:
    """The plain form of the decimating tensor-core route (windows of the
    stream, 8 outputs apart, against the strided Toeplitz matrix of the
    taps, k-step by k-step) held against the twin and against grtpu's Pallas
    kernel in interpret mode."""

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("rows", [1, 4])
    @pytest.mark.parametrize("k", [33, 155, 193])
    @pytest.mark.parametrize("d", [1, 2, 4, 8])
    def test_vs_twin(self, d, k, rows, precision):
        """An output count that is no multiple of 8, a lead, and row b on
        tap set b % G (two sets where there are four rows); at decimation 1
        a tile is 128 consecutive outputs, 16 windows 8 samples apart."""
        rng = np.random.RandomState(1000 * d + k + rows)
        g = 2 if rows == 4 else 1
        ts = T((rng.randn(g, k) / np.sqrt(k)).astype(np.float32))
        for lead, nout in ((0, 8 * 37 + 5), (k // 2, 61)):
            x = T(rng.randn(rows, nout * d + k - 1 - lead).astype(np.float32))
            got = cf.fir_decim_mma_ref(x, ts, d, lead, nout, precision)
            ref = cf.fir_tile_ref(x, ts, d, lead, nout, precision)
            assert got.shape == (rows, nout)
            assert rel(got.numpy(), ref.numpy()) < TOL[precision]

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("k", [33, 155, 193])
    @pytest.mark.parametrize("d", [2, 4, 8])
    def test_vs_pallas_fir_decim(self, d, k, precision):
        rng = np.random.RandomState(2000 * d + k)
        for rows in (1, 4):
            x = rng.randn(rows, 256 * d + k - 1).astype(np.float32)
            taps = (rng.randn(k) / np.sqrt(k)).astype(np.float32)
            ref = np.asarray(jpf.fir_decim(jnp.asarray(x), taps, d,
                                           interpret=True,
                                           precision=precision))
            got = cf.fir_decim_mma_ref(T(x), T(taps)[None], d, 0, 256,
                                       precision).numpy()
            assert rel(got, ref) < TOL[precision]

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("rows", [1, 4])
    @pytest.mark.parametrize("d,k", [(2, 33), (4, 193), (8, 155)])
    @pytest.mark.parametrize("sig", ["ccf", "ccc"])
    def test_vs_pallas_fir_decim_c(self, sig, d, k, rows, precision):
        """The complex modes' plain form (fir_decim_cplx_ref: one sum a
        stream plane and tap plane) and the complex stream's two planes as
        extra rows of the tensor-core route's plain form, against grtpu's
        fir_decim_c (ccf) and fir_decim_cc (ccc)."""
        rng = np.random.RandomState(3000 * d + k + rows)
        n = 128 * d
        x = (rng.randn(rows, n + k - 1)
             + 1j * rng.randn(rows, n + k - 1)).astype(np.complex64)
        taps = (rng.randn(k) / np.sqrt(k)).astype(np.float32)
        if sig == "ccc":
            taps = (taps + 1j * rng.randn(k) / np.sqrt(k)).astype(
                np.complex64)
        fn = jpf.fir_decim_c if sig == "ccf" else jpf.fir_decim_cc
        ref = np.asarray(fn(jnp.asarray(x), taps, d, interpret=True,
                            precision=precision))
        got = cf.fir_decim_cplx_ref(T(x), T(taps), d, 0, 128, precision,
                                    cf.CCF if sig == "ccf" else cf.CCC)
        assert got.dtype == torch.complex64
        assert rel(got.numpy(), ref) < TOL[precision]
        planes = T(np.concatenate([x.real, x.imag]))

        def mma(t):
            t = T(np.ascontiguousarray(t))[None]
            return cf.fir_decim_mma_ref(planes, t, d, 0, 128,
                                        precision).numpy()

        if sig == "ccf":
            y = mma(taps)
            plane = y[:rows] + 1j * y[rows:]
        else:
            yr, yi = mma(taps.real), mma(taps.imag)
            plane = (yr[:rows] - yi[rows:]) + 1j * (yi[:rows] + yr[rows:])
        assert rel(plane, ref) < TOL[precision]

    @pytest.mark.parametrize("cplx", [1, 2])
    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    def test_complex_modes_tapsets_and_lead(self, precision, cplx):
        """fir_decim_cplx_ref's contract on its own: row b on tap set b % G
        for both planes, a lead of zeros, zeros past the stream's end; the
        four sums of ccc combined as (re.tr - im.ti) + j (re.ti + im.tr)."""
        rng = np.random.RandomState(60 + cplx)
        g, k, d, lead, nout, b = 2, 17, 3, 5, 40, 4
        x = (rng.randn(b, 100) + 1j * rng.randn(b, 100)).astype(np.complex64)
        ts = rng.randn(g, k).astype(np.float32)
        if cplx == cf.CCC:
            ts = (ts + 1j * rng.randn(g, k)).astype(np.complex64)
        got = cf.fir_decim_cplx_ref(T(x), T(ts), d, lead, nout, precision,
                                    cplx).numpy()
        xp = np.concatenate([np.zeros((b, lead)), x, np.zeros((b, 200))], 1)
        want = np.array([[np.dot(ts[r % g][::-1], xp[r, i * d:i * d + k])
                          for i in range(nout)] for r in range(b)])
        assert rel(got, want) < TOL[precision]

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("cplx", [1, 2])
    @pytest.mark.parametrize("k", [16, 155])
    def test_decim1_complex_vs_twin(self, k, cplx, precision):
        """The tensor-core route's plain form at decimation 1 over a complex
        stream's planes, one sum a (stream plane, tap plane) pair combined
        as fir_decim_mma_fwd's complex modes combine them, against
        fir_decim_cplx_ref (fir_tile_ref a pair): a lead, an output count
        no multiple of 8, two tap sets on three rows, zeros past the
        stream's end."""
        rng = np.random.RandomState(80 + k + cplx)
        b, g, lead, nout = 3, 2, 11, 8 * 29 + 3
        x = T((rng.randn(b, nout + k - 1 - lead - 5)
               + 1j * rng.randn(b, nout + k - 1 - lead - 5))
              .astype(np.complex64))
        ts = rng.randn(g, k) / np.sqrt(k)
        if cplx == cf.CCC:
            ts = ts + 1j * rng.randn(g, k) / np.sqrt(k)
        ts = T(ts.astype(np.complex64 if cplx == cf.CCC else np.float32))

        def mma(plane, t):
            return cf.fir_decim_mma_ref(plane, t.contiguous(), 1, lead, nout,
                                        precision)

        if cplx == cf.CCF:
            got = torch.complex(mma(x.real, ts), mma(x.imag, ts))
        else:
            tr, ti = ts.real, ts.imag
            got = torch.complex(mma(x.real, tr) - mma(x.imag, ti),
                                mma(x.real, ti) + mma(x.imag, tr))
        ref = cf.fir_decim_cplx_ref(x, ts, 1, lead, nout, precision, cplx)
        assert got.shape == ref.shape == (b, nout)
        assert rel(got.numpy(), ref.numpy()) < TOL[precision]

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("g,c", [(1, 3), (2, 4), (3, 6), (2, 3)])
    @pytest.mark.parametrize("sig", ["ccf", "ccc"])
    def test_decim1_vs_pallas(self, sig, g, c, precision):
        """fir_decim_cplx_ref at decimation 1, the plain form of both
        one-launch routes there, against grtpu: at G = 1 its fir_decim_c /
        fir_decim_cc in interpret mode; where G divides C its stacked
        planes through the kernel fir_decim_c takes at decimation 1
        (_phase_batched, row C + c on set (C + c) % G = c % G); where G
        does not divide C, grtpu's planes would give row C + c another set,
        so against a per-row float64 sum.  The port's public call on the
        CPU tensor gives the same."""
        rng = np.random.RandomState(90 + 10 * g + c)
        k, n = 37, 200
        x = (rng.randn(c, n + k - 1) + 1j * rng.randn(c, n + k - 1)).astype(
            np.complex64)
        taps = rng.randn(g, k) / np.sqrt(k)
        if sig == "ccc":
            taps = taps + 1j * rng.randn(g, k) / np.sqrt(k)
        taps = taps.astype(np.complex64 if sig == "ccc" else np.float32)
        cplx = cf.CCF if sig == "ccf" else cf.CCC
        got = cf.fir_decim_cplx_ref(T(x), T(taps), 1, 0, n, precision, cplx)
        if g == 1:
            fn = jpf.fir_decim_c if sig == "ccf" else jpf.fir_decim_cc
            ref = np.asarray(fn(jnp.asarray(x), taps[0], 1, interpret=True,
                                precision=precision))
        elif c % g == 0:
            planes = jnp.asarray(np.concatenate([x.real, x.imag]))

            def grid(t):
                return np.asarray(jpf._phase_batched(
                    planes, [np.ascontiguousarray(r, np.float32) for r in t],
                    n, 1024, True, precision))[:, :n]

            if sig == "ccf":
                y = grid(taps)
                ref = y[:c] + 1j * y[c:]
            else:
                yr, yi = grid(taps.real), grid(taps.imag)
                ref = (yr[:c] - yi[c:]) + 1j * (yi[:c] + yr[c:])
        else:
            xd = x.astype(np.complex128)
            ref = np.array([[np.dot(taps[r % g][::-1].astype(np.complex128),
                                    xd[r, i:i + k]) for i in range(n)]
                            for r in range(c)])
        assert got.dtype == torch.complex64 and got.shape == (c, n)
        assert rel(got.numpy(), ref) < TOL[precision]
        fn = cf.fir_decim_c if sig == "ccf" else cf.fir_decim_cc
        assert torch.equal(fn(T(x), taps, 1, precision=precision), got)

    def test_short_stream_and_bf16_resident_input(self):
        """A stream shorter than one window reads zeros past its end, and a
        bfloat16 stream gives what the float32 stream gives at bf16."""
        rng = np.random.RandomState(41)
        x = T(rng.randn(2, 100).astype(np.float32))
        ts = T((rng.randn(1, 64) * 0.1).astype(np.float32))
        got = cf.fir_decim_mma_ref(x, ts, 8, 500, 50, "bf16x3")
        ref = cf.fir_tile_ref(x, ts, 8, 500, 50, "bf16x3")
        assert rel(got.numpy(), ref.numpy()) < TOL["bf16x3"]
        y32 = cf.fir_decim_mma_ref(x, ts, 4, 0, 9, "bf16")
        y16 = cf.fir_decim_mma_ref(x.to(torch.bfloat16), ts, 4, 0, 9, "bf16")
        assert torch.equal(y32, y16)

    @pytest.mark.parametrize("k,d", [(1, 2), (33, 2), (193, 8), (155, 8),
                                     (40, 3), (4097, 16)])
    def test_strided_toeplitz_taps(self, k, d):
        """T[c, o] = taps[K-1 - (c - o*d)], zero where that is no tap."""
        taps = np.random.RandomState(k).randn(k).astype(np.float32)
        t = cf.strided_toeplitz_taps(T(taps), d).numpy()
        ks = -(-(8 * d + k - 1) // 16)
        assert t.shape == (16 * ks, 8)
        for c, o in ((0, 0), (k - 1, 0), (k, 0), (7 * d, 7), (7 * d - 1, 7),
                     (7 * d + k - 1, 7), (16 * ks - 1, 7), (d, 1), (5, 3)):
            m = c - o * d
            want = taps[k - 1 - m] if 0 <= m < k else 0.0
            assert t[c, o] == want, (c, o)


class TestRoutesAndPlans:
    """Which kernel a single-stage call takes, and with what launch."""

    @pytest.mark.parametrize("precision,d,k,b,nout,want", [
        ("f32", 1, 4097, 16, 1 << 20, "tile"),
        ("bf16x3", 1, 4097, 16, 1 << 20, "toeplitz"),
        ("bf16", 1, 4097, 16, 1 << 20, "toeplitz"),
        ("bf16", 1, cf._TZ_MIN_TAPS - 1, 16, 1 << 20, "tile"),
        ("bf16", 1, cf._TZ_MIN_TAPS, 16, 1 << 20, "toeplitz"),
        ("bf16x3", 1, cf._TZ_MAX_TAPS["bf16x3"], 1, 1000, "toeplitz"),
        ("bf16x3", 1, cf._TZ_MAX_TAPS["bf16x3"] + 1, 1, 1000, "tile"),
        ("f32", 8, 193, 1, 8192, "decim_fma"),
        ("bf16x3", 8, 193, 1, 8192, "decim_mma"),
        ("bf16", 8, 155, 64, 1 << 15, "decim_mma"),
        ("bf16x3", 2, 64, 4, 4096, "decim_mma"),
        ("bf16x3", 2, 63, 4, 4096, "decim_fma"),
        ("bf16", 2, 128, 4, 4096, "decim_mma"),
        ("bf16", 2, 127, 4, 4096, "decim_fma"),
        ("bf16", 4, 64, 4, 4096, "decim_mma"),
        ("bf16", 4, 63, 4, 4096, "decim_fma"),
        ("bf16x3", 3, 16, 4, 4096, "decim_mma"),
        ("bf16", 8, 16, 4, 4096, "decim_mma"),
        ("bf16", 8, 15, 4, 4096, "decim_fma"),
        ("bf16x3", 16, 15, 4, 4096, "decim_fma"),
        ("bf16x3", 3, 2100, 2, 500, "decim_mma"),
        ("f32", 3, 60000, 2, 500, "tile"),
        ("bf16x3", 8, 193, 1, 0, "empty"),
        ("f32", 1, 5, 0, 100, "empty"),
    ])
    def test_route(self, precision, d, k, b, nout, want):
        assert cf._route(precision, d, k, b, nout) == want

    @pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
    def test_forced_fma_keeps_off_the_tensor_cores(self, precision):
        assert cf._route(precision, 8, 193, 1, 8192, fma=True) == "decim_fma"
        assert cf._route(precision, 1, 4097, 16, 1 << 20, fma=True) == "tile"

    def test_chunk_fills_the_card(self):
        """One row of 8,192 outputs (a 65,536-sample chunk at decimation 8)
        becomes at least one block an SM."""
        mtb, to, tpb = cf._decim_mma_plan("bf16x3", 8, 193, 1, 8192)
        assert mtb == 1 and tpb == 1 and to % 8 == 0 and to <= 128
        assert -(-8192 // to) >= cf._H100_SMS

    @pytest.mark.parametrize("b,nout", [(64, 1 << 15), (128, 1 << 15),
                                        (1, 8192), (3, 1000), (1, 5)])
    def test_mma_plan_covers_the_outputs(self, b, nout):
        mtb, to, tpb = cf._decim_mma_plan("bf16x3", 8, 155, b, nout)
        assert mtb in (1, 2, 4) and 1 <= to <= 128 * mtb and tpb >= 1
        assert to == 128 * mtb or mtb == 1
        kp, tpb = cf._decim_fma_plan("f32", 8, 155, b, nout)
        assert kp in (1, 2, 4) and tpb >= 1

    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("d", [2, 3, 4, 8, 16])
    @pytest.mark.parametrize("k", [16, 193, 4097])
    def test_plans_fit_shared_memory(self, k, d, precision):
        """At decimations up to 16 and up to 4097 taps both decimating
        kernels have a plan whose block fits the 232,448 bytes a block may
        opt into."""
        for b, nout in ((1, 8192), (64, 1 << 15)):
            kp, tpb = cf._decim_fma_plan(precision, d, k, b, nout)
            assert cf._decim_smem(precision, 4, k, d, kp) <= 232448
            if precision != "f32":
                mtb, to, tpb = cf._decim_mma_plan(precision, d, k, b, nout)
                assert cf._decim_mma_smem(precision, 4, k, d, mtb) <= 232448

    @pytest.mark.parametrize("cplx", [1, 2])
    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("d", [2, 3, 4, 8, 16])
    @pytest.mark.parametrize("k", [16, 193, 4097])
    def test_complex_plans_fit_shared_memory(self, k, d, precision, cplx):
        """At decimations 2 to 16 and up to 4097 taps a complex stream takes
        one decimating launch in its complex mode, whose block fits the
        232,448 bytes a block may opt into (without the ring where the ring
        does not fit; the bytes are the launch's either way)."""
        for b, nout in ((1, 8192), (64, 1 << 15)):
            route = cf._route(precision, d, k, b, nout, cplx=cplx)
            assert route in ("decim_mma", "decim_fma")
            if route == "decim_mma":
                mtb, to, tpb = cf._decim_mma_plan(precision, d, k, b, nout,
                                                  cplx=cplx)
                smem = cf._decim_mma_smem(precision, 8, k, d, mtb, cplx)
            else:
                kp, tpb = cf._decim_fma_plan(precision, d, k, b, nout,
                                             cplx=cplx)
                smem = cf._decim_smem(precision, 8, k, d, kp, cplx)
            assert smem <= 232448

    @pytest.mark.parametrize("cplx", [1, 2])
    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("k", [16, 155, 4097])
    def test_decim1_complex_plans_fit_shared_memory(self, k, precision,
                                                    cplx):
        """A complex stream at decimation 1 takes one launch as the record
        has it: the tensor cores in the bf16 modes, fir_decim_fwd (one phase
        group) in f32 below _D1_TILE_TAPS taps and fir_tile_fwd's complex
        mode from them; only the bf16 modes' long filters take the stacked
        planes on fir_toeplitz_fwd.  Every route's block fits the 232,448
        bytes a block may opt into, four tensor-core tiles a block where
        the grid fills the card twice, at most two tiles a block."""
        want = {16: ("decim_fma", "decim_mma"), 155: ("decim_fma",
                                                       "decim_mma"),
                4097: ("tile", "planes")}[k][precision != "f32"]
        for b, nout in ((1, 65536), (64, 1 << 18), (3, 1000)):
            assert cf._route(precision, 1, k, b, nout, cplx=cplx) == want
            if precision != "f32":
                mtb, to, tpb = cf._decim_mma_plan(precision, 1, k, b, nout,
                                                  cplx=cplx)
                assert cf._decim_mma_smem(precision, 8, k, 1, mtb,
                                          cplx) <= 232448
                assert tpb <= cf._D1_TILES_A_BLOCK
                if b * -(-nout // 512) >= 2 * cf._H100_SMS:
                    assert (mtb, to) == (4, 512)
            threads, kblk = cf._tile_plan(precision, 1, k, b, nout,
                                          cplx=cplx)
            assert cf._tile_smem(precision, threads, 1, kblk,
                                 cplx) <= 232448
            kp, tpb = cf._decim_fma_plan(precision, 1, k, b, nout, cplx=cplx)
            assert kp == 1 and tpb <= cf._D1_TILES_A_BLOCK
            assert cf._decim_smem(precision, 8, k, 1, kp, cplx) <= 232448

    @pytest.mark.parametrize("cplx", [0, 1, 2])
    @pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
    @pytest.mark.parametrize("d", [1, 3, 16])
    @pytest.mark.parametrize("k", [16, 155, 4097])
    def test_tile_plans_fit_shared_memory(self, k, d, precision, cplx):
        """fir_tile_fwd's block in every stream mode: the complex modes'
        two windows (and ccc's two tap rows) twice the real block's, within
        the 232,448 bytes at 4097 taps, threads * 8 outputs a tile spanning
        at most _MAX_TILE_SPAN samples; the real plan is the parent's."""
        for b, nout in ((1, 8192), (64, 1 << 15)):
            threads, kblk = cf._tile_plan(precision, d, k, b, nout,
                                          cplx=cplx)
            assert 32 <= threads <= cf._THREADS and 1 <= kblk <= cf._KBLK
            assert cf._tile_smem(precision, threads, d, kblk,
                                 cplx) <= 232448
            if cplx:
                assert cf._tile_smem(precision, threads, d, kblk, cplx) > \
                    cf._tile_smem(precision, threads, d, kblk)
            else:
                assert kblk == min(k, cf._KBLK)

    def test_tile_plan_shrinks_to_fit(self):
        """Where a complex block does not fit shared memory, the taps a pass
        shrink first, then the threads; where nothing fits, None (and the
        complex route falls back to "planes" only there)."""
        plan = cf._tile_plan("bf16x3", 40, 60000, 2, 500, cplx=cf.CCC)
        assert plan is not None and plan[1] < cf._KBLK
        assert cf._tile_smem("bf16x3", plan[0], 40, plan[1],
                             cf.CCC) <= cf._SMEM_OPTIN
        assert cf._tile_plan("bf16x3", 100, 60000, 2, 500,
                             cplx=cf.CCC) is None
        assert cf._route("bf16x3", 100, 8, 2, 500, cplx=cf.CCC) == "planes"

    @pytest.mark.parametrize("precision,d,k,b,nout,cplx,want", [
        ("bf16x3", 1, 99, 1, 65536, 2, "decim_mma"),
        ("f32", 1, 4097, 16, 1 << 20, 1, "tile"),
        ("bf16", 1, 64, 2, 100, 1, "decim_mma"),
        ("bf16x3", 8, 155, 64, 1 << 15, 1, "decim_mma"),
        ("bf16x3", 8, 99, 1, 65536, 2, "decim_mma"),
        ("f32", 8, 155, 64, 1 << 15, 2, "decim_fma"),
        ("bf16x3", 2, 96, 4, 4096, 2, "decim_mma"),
        ("bf16x3", 2, 9, 1, 32, 2, "decim_fma"),
        ("bf16", 8, 15, 4, 4096, 1, "decim_fma"),
        ("f32", 16, 4097, 2, 300, 2, "decim_fma"),
        ("f32", 3, 60000, 2, 500, 1, "tile"),
        ("bf16x3", 8, 155, 0, 100, 2, "empty"),
        # the crossovers at decimation 1: the tensor cores from
        # _dm_min_taps taps, fir_decim_fwd below; in f32 fir_decim_fwd
        # below _D1_TILE_TAPS, fir_tile_fwd from them; the bf16 modes' long
        # filters on the stacked planes (fir_toeplitz_fwd) from
        # _D1_PLANES_TAPS to _TZ_MAX_TAPS
        ("bf16x3", 1, cf._dm_min_taps("bf16x3", 1, 1), 4, 4096, 1,
         "decim_mma"),
        ("bf16x3", 1, cf._dm_min_taps("bf16x3", 1, 1) - 1, 4, 4096, 1,
         "decim_fma"),
        ("bf16", 1, cf._dm_min_taps("bf16", 1, 2), 64, 1 << 18, 2,
         "decim_mma"),
        ("bf16", 1, cf._dm_min_taps("bf16", 1, 2) - 1, 64, 1 << 18, 2,
         "decim_fma"),
        ("f32", 1, 155, 64, 1 << 18, 2, "decim_fma"),
        ("f32", 1, cf._D1_TILE_TAPS - 1, 4, 4096, 2, "decim_fma"),
        ("f32", 1, cf._D1_TILE_TAPS, 4, 4096, 1, "tile"),
        ("bf16x3", 1, cf._D1_PLANES_TAPS[1] - 1, 4, 4096, 1, "decim_mma"),
        ("bf16x3", 1, cf._D1_PLANES_TAPS[1], 4, 4096, 1, "planes"),
        ("bf16", 1, cf._D1_PLANES_TAPS[2] - 1, 4, 4096, 2, "decim_mma"),
        ("bf16", 1, cf._D1_PLANES_TAPS[2], 4, 4096, 2, "planes"),
        ("bf16x3", 1, cf._TZ_MAX_TAPS["bf16x3"] + 1, 4, 4096, 1,
         "decim_mma"),
    ])
    def test_complex_route(self, precision, d, k, b, nout, cplx, want):
        """A complex call is one launch by shape, as the record has it:
        decimation 1 on the tensor cores, fir_decim_fwd or fir_tile_fwd,
        windows too large for the decimating kernels fir_tile_fwd's complex
        mode; the stacked planes only for the bf16 modes' long filters at
        decimation 1, where they measured faster."""
        assert cf._route(precision, d, k, b, nout, cplx=cplx) == want

    def test_complex_ring_only_where_it_fits(self):
        """The three stages of raw complex samples are dropped only where
        the block would not fit with them: the bank keeps its ring, 4097
        taps at decimation 16 take their windows from device memory."""
        ring = 3 * cf._ring_stage_bytes(255 * 8 + 155, 8)
        assert cf._decim_smem("f32", 8, 155, 8, 4, cf.CCC) > ring
        long_ = cf._decim_smem("f32", 8, 4097, 16, 4, cf.CCC)
        ring16 = 3 * cf._ring_stage_bytes(255 * 16 + 4097, 8)
        assert long_ + ring16 > cf._SMEM_OPTIN >= long_

    def test_complex_plans_are_kept(self):
        """One plan per shape and stream mode, computed once; the real and
        the complex plan of a shape are kept apart."""
        for fn in (cf._decim_mma_plan, cf._decim_fma_plan):
            fn.cache_clear()
            args = ("bf16x3", 8, 155, 64, 1 << 15)
            first = fn(*args, cplx=cf.CCC)
            assert fn(*args, cplx=cf.CCC) is first
            assert fn.cache_info().hits == 1 and fn.cache_info().misses == 1
            fn(*args)
            assert fn.cache_info().misses == 2
        assert "cplx" in cf._launch_plan.__wrapped__.__code__.co_varnames

    def test_plans_are_kept(self):
        """The same key gives the same plan object, computed once."""
        for fn, args in ((cf._decim_mma_plan, ("bf16x3", 8, 193, 1, 8192)),
                         (cf._decim_fma_plan, ("f32", 8, 155, 64, 1 << 15)),
                         (cf._cascade_plan, (1 << 20, 256, 16, "f32"))):
            fn.cache_clear()
            first = fn(*args)
            assert fn(*args) is first
            assert fn.cache_info().hits == 1 and fn.cache_info().misses == 1
        assert hasattr(cf._launch_plan, "cache_info")

    @pytest.mark.parametrize("n,k,s,precision,want", [
        (1 << 20, 256, 16, "f32", (21504, 1024)),
        (1 << 20, 256, 16, "bf16x3", (8192, 1024)),
        (128, 5, 2, "f32", (256, 256)),
        (1 << 14, 4097, 4, "f32", (3072, 256)),
    ])
    def test_cascade_plan(self, n, k, s, precision, want):
        tile, threads = cf._cascade_plan(n, k, s, precision)
        assert (tile, threads) == want
        assert cf._cascade_smem(precision, k, s, tile) <= 232448


class TestFirFilterKernelImpl:
    """FirFilter(impl='kernel') inside a graph equals grtpu's
    FirFilter(impl='pallas') (interpret mode via monkeypatch, as in
    tests/test_fir.py:497-528) and the port's own mxu path."""

    @pytest.mark.parametrize("sig,d", [("fff", 1), ("fff", 4), ("ccf", 4),
                                       ("ccc", 2)])
    def test_graph(self, monkeypatch, sig, d):
        import grtpu
        from grtpu.blocks.filter import FirFilter as JFir
        import grtpu_torch
        from grtpu_torch.blocks.filter import FirFilter as TFir

        rng = np.random.RandomState(16 + d)
        k = 65
        cplx = sig[0] == "c"
        taps = (rng.randn(k) * 0.05).astype(np.float32)
        if sig == "ccc":
            taps = (taps + 1j * rng.randn(k) * 0.05).astype(np.complex64)
        x = rng.randn(2048).astype(np.float32)
        if cplx:
            x = (x + 1j * rng.randn(2048)).astype(np.complex64)
        name = {"fff": "fir_decim", "ccf": "fir_decim_c",
                "ccc": "fir_decim_cc"}[sig]
        monkeypatch.setattr(jpf, name, functools.partial(
            getattr(jpf, name), interpret=True, precision="bf16x3",
            tile_rows=256))

        def run(pkg, fir_cls, impl, dtype):
            g = pkg.Graph()
            pin = g.add_input(pkg.Port(dtype[0]))
            pout = g.add_output(pkg.Port(dtype[1]))
            g.connect(pin, fir_cls(d, taps, sig, impl=impl), pout)
            kw = {"device": "cpu"} if pkg is grtpu_torch else {}
            return pkg.StreamExecutor(g, chunk_size=512, **kw).run(
                jnp.asarray(x) if pkg is grtpu else x)

        jd = (jnp.complex64 if cplx else jnp.float32,
              jnp.float32 if sig == "fff" else jnp.complex64)
        td = (torch.complex64 if cplx else torch.float32,
              torch.float32 if sig == "fff" else torch.complex64)
        ref = np.asarray(run(grtpu, JFir, "pallas", jd))
        got = run(grtpu_torch, TFir, "kernel", td).numpy()
        # the port's kernel impl defaults to bf16x3, like grtpu's
        assert rel(got, ref) < TOL["bf16x3"]
        mxu = run(grtpu_torch, TFir, "mxu", td).numpy()
        assert rel(got, mxu) < TOL["bf16x3"]

    def test_pallas_alias_and_guard(self):
        from grtpu_torch.blocks.filter import FirFilter

        assert FirFilter(2, np.ones(5), "fff", impl="pallas").impl == "kernel"
        with pytest.raises(ValueError):
            FirFilter(1, np.ones(5), "fcc", impl="kernel")
