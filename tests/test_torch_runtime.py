"""grtpu_torch's runtime (Block, Graph, StreamExecutor) held against grtpu.

The same flowgraphs, built block for block in both packages, run over the
same numpy inputs (local seeds): halo history across chunks, decimation,
chunk-size invariance, required_multiple, demand balancing, sources,
sinks, hierarchy, the stale-parameter guard and checkpoints.  Outputs
agree to max|diff| / max|grtpu| < 1e-5 (grtpu's float32 FIR tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu.blocks.filter as jfilt  # noqa: E402
import grtpu.blocks.gengen as jgen  # noqa: E402
import grtpu_torch  # noqa: E402
import grtpu_torch.blocks.filter as tfilt  # noqa: E402
import grtpu_torch.blocks.gengen as tgen  # noqa: E402

PKGS = {
    "jax": (grtpu, jfilt, jgen, jnp.float32, jnp.asarray),
    "torch": (grtpu_torch, tfilt, tgen, torch.float32, lambda a: a),
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def cpu(pkg):
    """Keyword that keeps a grtpu_torch entry point on the CPU (its default
    device is the card); grtpu takes no such argument."""
    return {"device": "cpu"} if pkg is grtpu_torch else {}


def fir_chain(kind, specs, chunk, **kw):
    """pad -> FirFilter(decim, taps) for each spec -> pad executor."""
    pkg, filt, _, f32, _ = PKGS[kind]
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(f32))
    pout = g.add_output(pkg.Port(f32))
    g.connect(pin, *[filt.FirFilter(d, t, "fff", impl="mxu") for d, t in specs],
              pout)
    return pkg.StreamExecutor(g, chunk_size=chunk, **kw, **cpu(pkg))


def run_both(specs, x, chunk):
    ys = {kind: out(fir_chain(kind, specs, chunk).run(PKGS[kind][4](x)))
          for kind in PKGS}
    return ys["torch"], ys["jax"]


def taps(rng, k):
    return (rng.randn(k) * 0.2).astype(np.float32)


class TestExecutorParity:
    def test_halo_across_chunks(self):
        rng = np.random.RandomState(1)
        t = taps(rng, 40)
        x = rng.randn(1000).astype(np.float32)  # not a chunk multiple
        got, ref = run_both([(1, t)], x, 64)
        assert got.shape == (1000,)
        assert rel(got, ref) < 1e-5
        full = np.convolve(np.concatenate([np.zeros(39), x]), t, "valid")
        assert rel(got, full) < 1e-5

    @pytest.mark.parametrize("decims", [(2,), (4, 2), (3, 2)])
    def test_decimation_chain(self, decims):
        rng = np.random.RandomState(2)
        specs = [(d, taps(rng, 9 + 4 * i)) for i, d in enumerate(decims)]
        x = rng.randn(96 * 17).astype(np.float32)
        got, ref = run_both(specs, x, 96)
        assert got.shape == (len(x) // int(np.prod(decims)),)
        assert rel(got, ref) < 1e-5

    def test_chunk_size_invariance(self):
        rng = np.random.RandomState(3)
        specs = [(1, taps(rng, 33)), (4, taps(rng, 17))]
        x = rng.randn(4096).astype(np.float32)
        a = out(fir_chain("torch", specs, 256).run(x))
        b = out(fir_chain("torch", specs, 1024).run(x))
        assert rel(a, b) < 1e-5
        _, ref = run_both(specs, x, 512)
        assert rel(a, ref) < 1e-5

    @pytest.mark.parametrize("decims", [(2,), (2, 3), (4, 4), (3, 2, 2), ()])
    def test_required_multiple(self, decims):
        specs = [(d, np.ones(3, np.float32)) for d in decims] or [
            (1, np.ones(3, np.float32))]
        m = {kind: fir_chain(kind, specs, int(np.prod(decims or (1,))) * 8
                             ).required_multiple() for kind in PKGS}
        assert m["torch"] == m["jax"] == int(np.prod(decims or (1,)))

    def test_auto_chunk_size(self):
        specs = [(3, np.ones(3, np.float32)), (2, np.ones(3, np.float32))]
        assert (fir_chain("torch", specs, None).chunk_size
                == fir_chain("jax", specs, None).chunk_size)

    def test_bad_chunk_divisibility(self):
        with pytest.raises(ValueError, match="not divisible"):
            fir_chain("torch", [(7, np.ones(3, np.float32))], 16)

    def test_stream_equals_run(self):
        rng = np.random.RandomState(4)
        specs = [(2, taps(rng, 21))]
        x = rng.randn(512).astype(np.float32)
        whole = out(fir_chain("torch", specs, 128).run(x))
        ex = fir_chain("torch", specs, 128)
        parts = [out(y) for y in ex.stream(x[i:i + 128]
                                           for i in range(0, 512, 128))]
        np.testing.assert_array_equal(np.concatenate(parts), whole)

    def test_step_fn_is_pure(self):
        ex = fir_chain("torch", [(1, np.arange(5, dtype=np.float32))], 8)
        step = ex.step_fn()
        x = (torch.arange(8, dtype=torch.float32),)
        s1, (p1, _) = step(ex.state, x)
        s2, (p2, _) = step(ex.state, x)
        assert torch.equal(p1[0], p2[0])
        s3, (p3, _) = step(s1, x)
        assert not torch.equal(p1[0], p3[0])  # the halo carried over

    def test_input_cast_to_pad_dtype(self):
        ex = fir_chain("torch", [(1, np.ones(1, np.float32))], 8)
        y = ex.run(np.arange(16, dtype=np.float64))
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), np.arange(16))


class _Add2Mixin:
    def apply(self, state, a, b):
        return state, a + b


def _add2(kind):
    pkg = PKGS[kind][0]
    f32 = PKGS[kind][3]

    class Add2(_Add2Mixin, pkg.Block):
        def __init__(self):
            self.in_ports = (pkg.Port(f32), pkg.Port(f32))
            self.out_ports = (pkg.Port(f32),)
            super().__init__()

    return Add2()


class TestSourcesSinksJoins:
    def test_vector_source_demand_balancing(self):
        """Two source roots join after a 2x decimator: the balancer doubles
        the decimated branch's source so both inputs of the join agree."""
        rng = np.random.RandomState(5)
        da = rng.randn(300).astype(np.float32)
        db = rng.randn(200).astype(np.float32)
        t = taps(rng, 7)
        res = {}
        for kind, (pkg, filt, gen, f32, _) in PKGS.items():
            g = pkg.Graph()
            add = _add2(kind)
            sink = gen.VectorSink()
            g.connect(gen.VectorSource(da), filt.FirFilter(2, t, "fff",
                                                           impl="mxu"),
                      (add, 0))
            g.connect(gen.VectorSource(db), (add, 1))
            g.connect(add, sink)
            ex = pkg.StreamExecutor(g, chunk_size=32, **cpu(pkg))
            ex.run(steps=5)
            res[kind] = sink.data()
        assert res["torch"].shape == (160,)
        assert isinstance(res["torch"], np.ndarray)
        assert rel(res["torch"], res["jax"]) < 1e-5

    def test_repeat_source_and_consts(self):
        res = {}
        for kind, (pkg, _, gen, f32, _) in PKGS.items():
            g = pkg.Graph()
            sink = gen.VectorSink()
            g.connect(gen.VectorSource(np.arange(5, dtype=np.float32),
                                       repeat=True),
                      gen.AddConst(2.0), gen.MultiplyConst(0.5), sink)
            ex = pkg.StreamExecutor(g, chunk_size=4, **cpu(pkg))
            ex.run(steps=4)
            res[kind] = sink.data()
            ex2 = pkg.StreamExecutor(g, chunk_size=4, **cpu(pkg))
            ex2.run(steps=3)
            res[kind + "2"] = sink.data()
        np.testing.assert_array_equal(res["torch"], res["jax"])
        np.testing.assert_array_equal(res["torch"],
                                      (np.arange(16) % 5 + 2) * 0.5)
        np.testing.assert_array_equal(res["torch2"], res["jax2"])

    def test_null_sink_and_pad_fanout(self):
        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        pout = g.add_output(grtpu_torch.Port(torch.float32))
        g.connect(pin, tgen.AddConst(1.0), pout)
        g.connect(pin, tgen.NullSink())
        y = grtpu_torch.StreamExecutor(g, chunk_size=8,
                                       device="cpu").run(np.zeros(16))
        np.testing.assert_array_equal(y.numpy(), np.ones(16))

    def test_hier_flatten(self):
        class PlusTimes(grtpu_torch.HierBlock):
            def __init__(self):
                super().__init__()
                i = self.graph.add_input(grtpu_torch.Port(torch.float32))
                o = self.graph.add_output(grtpu_torch.Port(torch.float32))
                self.graph.connect(i, tgen.AddConst(1.0),
                                   tgen.MultiplyConst(2.0), o)

        class Outer(grtpu_torch.HierBlock):
            def __init__(self):
                super().__init__()
                i = self.graph.add_input(grtpu_torch.Port(torch.float32))
                o = self.graph.add_output(grtpu_torch.Port(torch.float32))
                self.graph.connect(i, PlusTimes(), PlusTimes(), o)

        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        pout = g.add_output(grtpu_torch.Port(torch.float32))
        g.connect(pin, Outer(), pout)
        ex = grtpu_torch.StreamExecutor(g, chunk_size=16, device="cpu")
        assert len(ex.flat.blocks) == 4
        x = np.arange(32, dtype=np.float32)
        np.testing.assert_array_equal(ex.run(x).numpy(), ((x + 1) * 2 + 1) * 2)

    def test_type_mismatch_raises(self):
        from grtpu_torch.blocks.analog import QuadratureDemod

        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        with pytest.raises(ValueError, match="type mismatch"):
            g.connect(pin, QuadratureDemod(1.0))

    def test_port_takes_numpy_dtypes(self):
        assert grtpu_torch.Port(np.complex64).dtype == torch.complex64
        assert grtpu_torch.Port(np.float32).compatible(
            grtpu_torch.Port(torch.float32))


class TestGuards:
    def test_stale_parameter_guard(self):
        ex = fir_chain("torch", [(1, np.ones(4, np.float32))], 8)
        blk = ex.order[0]
        ex.run(np.zeros(8))
        blk.set_taps(np.full(4, 2.0, np.float32))
        with pytest.raises(RuntimeError, match="changed after"):
            ex.run(np.zeros(8))
        # a rebuilt executor sees the new taps
        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        pout = g.add_output(grtpu_torch.Port(torch.float32))
        g.connect(pin, blk, pout)
        y = grtpu_torch.StreamExecutor(g, chunk_size=8,
                                       device="cpu").run(np.ones(8))
        assert y[-1].item() == 8.0

    def test_only_stream_tags_raise(self):
        """Every executor feature of grtpu is ported: device_loop, fuse_firs
        and debug_taps run, and add_tags (the last to come) carries tags
        through a decimating chain to the output pad as grtpu does."""
        ex = fir_chain("torch", [(1, np.ones(3, np.float32))], 8,
                       debug_taps=True, fuse_firs=True)
        ex.run(np.zeros(8))
        fir_chain("torch", [(1, np.ones(3, np.float32))], 8).run(
            np.zeros(8), device_loop=True)
        from grtpu.runtime.tags import Tag as JTag
        from grtpu_torch.runtime.tags import Tag as TTag

        specs = [(2, np.ones(3, np.float32)), (2, np.ones(5, np.float32))]
        got = {}
        for kind, Tag in (("torch", TTag), ("jax", JTag)):
            for mode in ((False, True) if kind == "torch" else (False,)):
                ex = fir_chain(kind, specs, 16)
                ex.add_tags(0, [Tag(3, "a", 1), Tag(21, "b", "x")])
                x = PKGS[kind][4](np.zeros(48, np.float32))
                if mode:
                    ex.run(x, device_loop=True)
                else:
                    ex.run(x)
                got[kind, mode] = sorted((t.offset, t.key, t.value)
                                         for t in ex.pad_tags[0])
        assert got["torch", False] == got["torch", True] == got["jax", False]
        assert got["jax", False] == [(0, "a", 1), (5, "b", "x")]

    def test_variable_rate_block_raises(self):
        """Variable-rate blocks run now; one that breaks the
        (state, (y_padded, n_valid)) contract raises."""
        class Vr(grtpu_torch.Block):
            variable_rate = True

            def __init__(self):
                self.in_ports = (grtpu_torch.Port(torch.float32),)
                self.out_ports = (grtpu_torch.Port(torch.float32),)
                super().__init__()

            def apply(self, state, x):
                return state, x

        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        pout = g.add_output(grtpu_torch.Port(torch.float32))
        g.connect(pin, Vr(), pout)
        ex = grtpu_torch.StreamExecutor(g, chunk_size=8, device="cpu")
        with pytest.raises(ValueError, match="variable-rate apply must return"):
            ex.run(np.zeros(8))


class TestCheckpoint:
    def _iir_chain(self, kind, rng_taps):
        pkg, filt, _, f32, _ = PKGS[kind]
        g = pkg.Graph()
        pin = g.add_input(pkg.Port(f32))
        pout = g.add_output(pkg.Port(f32))
        g.connect(pin, filt.FirFilter(2, rng_taps, "fff", impl="mxu"),
                  filt.IirFilter([0.3, 0.2], [1.0, 0.5]),
                  filt.SinglePoleIir(0.1), pout)
        return pkg.StreamExecutor(g, chunk_size=64, **cpu(pkg))

    def test_roundtrip(self, tmp_path):
        rng = np.random.RandomState(6)
        t = taps(rng, 11)
        x = rng.randn(256).astype(np.float32)
        ex = self._iir_chain("torch", t)
        ex.run(x[:128])
        path = str(tmp_path / "ckpt.npz")
        ex.save_checkpoint(path)
        y1 = ex.run(x[128:]).numpy()
        ex2 = self._iir_chain("torch", t)
        ex2.load_checkpoint(path)
        np.testing.assert_array_equal(ex2.run(x[128:]).numpy(), y1)

    def test_same_canonical_paths_as_grtpu(self, tmp_path):
        t = np.ones(11, np.float32)
        for kind in PKGS:
            self._iir_chain(kind, t).save_checkpoint(str(tmp_path / kind))
        a = np.load(str(tmp_path / "torch.npz"))
        b = np.load(str(tmp_path / "jax.npz"))
        assert list(a["__paths__"]) == list(b["__paths__"])
        for j in range(len(a["__paths__"])):
            assert a[f"arr_{j}"].shape == b[f"arr_{j}"].shape
            assert a[f"arr_{j}"].dtype == b[f"arr_{j}"].dtype

    def test_mismatched_graph_rejected(self, tmp_path):
        path = str(tmp_path / "c.npz")
        fir_chain("torch", [(1, np.ones(5, np.float32))], 8).save_checkpoint(path)
        other = fir_chain("torch", [(1, np.ones(7, np.float32))], 8)
        with pytest.raises(ValueError, match="does not match"):
            other.load_checkpoint(path)
