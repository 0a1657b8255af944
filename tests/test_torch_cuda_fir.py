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
            return pkg.StreamExecutor(g, chunk_size=512).run(
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
