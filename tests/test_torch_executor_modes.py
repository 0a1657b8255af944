"""grtpu_torch's executor run modes held against grtpu on the CPU:
``run(device_loop=True)``, ``fuse_firs`` and ``debug_taps``.

``device_loop`` on a CPU device runs the static-buffer form of the step (the
buffers, copy-in and copy-out, the pieces cut at each variable-rate push,
the output assembly) with each piece called where the card replays a CUDA
graph; its output must equal the port's eager run exactly, and grtpu's own
``device_loop`` run within grtpu's tolerances (FIR 1e-5; symbol decisions
identical).  ``fuse_firs`` and ``debug_taps`` follow grtpu's tests
(tests/test_fir.py:464-495, tests/test_runtime.py:344-363).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu.blocks.analog as janalog  # noqa: E402
import grtpu.blocks.filter as jfilt  # noqa: E402
import grtpu.blocks.gengen as jgen  # noqa: E402
import grtpu.blocks.stream as jstream  # noqa: E402
import grtpu.digital.blocks as jdb  # noqa: E402
from grtpu.ops.fir import compose_taps as j_compose  # noqa: E402
import grtpu_torch  # noqa: E402
import grtpu_torch.blocks.analog as tanalog  # noqa: E402
import grtpu_torch.blocks.filter as tfilt  # noqa: E402
import grtpu_torch.blocks.gengen as tgen  # noqa: E402
import grtpu_torch.blocks.stream as tstream  # noqa: E402
import grtpu_torch.digital.blocks as tdb  # noqa: E402
from grtpu_torch.ops import cuda_fir  # noqa: E402
from grtpu_torch.runtime.optimize import fuse_fir_chains  # noqa: E402

PKGS = {
    "jax": (grtpu, jfilt, jgen, jstream, jdb, jnp.float32),
    "torch": (grtpu_torch, tfilt, tgen, tstream, tdb, torch.float32),
}


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def executor(kind, g, chunk, **kw):
    pkg = PKGS[kind][0]
    extra = {"device": "cpu"} if kind == "torch" else {"donate": False}
    return pkg.StreamExecutor(g, chunk_size=chunk, **kw, **extra)


def chain(kind, blocks, in_dtype=None, out_dtype=None):
    """input pad -> blocks -> output pad, in package ``kind``."""
    pkg, f32 = PKGS[kind][0], PKGS[kind][5]
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(in_dtype or f32))
    pout = g.add_output(pkg.Port(out_dtype or blocks[-1].out_ports[0].dtype))
    g.connect(pin, *blocks, pout)
    return g


def fir_specs(seed=0):
    r = np.random.RandomState(seed)
    return [(1, (r.randn(31) * 0.1).astype(np.float32)),
            (2, (r.randn(17) * 0.1).astype(np.float32))]


def fir_graph(kind, specs, **kw):
    filt = PKGS[kind][1]
    return chain(kind, [filt.FirFilter(d, t, "fff", impl="mxu", **kw)
                        for d, t in specs])


def mm_graph(kind, tail=()):
    db, f32 = PKGS[kind][4], PKGS[kind][5]
    blocks = [db.ClockRecoveryMMFF(4, 0.25e-4, 0.5, 0.01)]
    blocks += [make(kind) for make in tail]
    return chain(kind, blocks, f32, blocks[-1].out_ports[0].dtype)


def nrz(seed=1, nsym=600, sps=4, n=2048):
    syms = np.random.RandomState(seed).choice([-1.0, 1.0], size=nsym)
    return np.repeat(syms, sps)[:n].astype(np.float32)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ------------------------------------------------------------------ device_loop
class TestDeviceLoop:
    @pytest.mark.parametrize("chunk,n", [(512, 4 * 512 + 100), (256, 1024)])
    def test_fixed_rate_matches_eager_and_grtpu(self, chunk, n):
        """grtpu's test_runtime.py:435-462: device_loop equals the stepwise
        run exactly, and a second run continues the stream; against grtpu's
        own device_loop within the FIR tolerance."""
        x = np.random.RandomState(0).randn(n).astype(np.float32)
        specs = fir_specs()
        eager = executor("torch", fir_graph("torch", specs), chunk)
        loop = executor("torch", fir_graph("torch", specs), chunk)
        ref = executor("jax", fir_graph("jax", specs), chunk)
        for _ in range(2):
            want = out(eager.run(x))
            got = out(loop.run(x, device_loop=True))
            np.testing.assert_array_equal(got, want)
            assert rel(got, out(ref.run(jnp.asarray(x), device_loop=True))) < 1e-5

    def test_vr_graph_decisions_match(self):
        """grtpu's test_runtime.py:465-485: the M&M graph under device_loop,
        equal to the port's eager run exactly; decisions and emission counts
        equal to grtpu's device_loop run."""
        x = nrz()
        got = out(executor("torch", mm_graph("torch"), 512).run(
            x, device_loop=True))
        want = out(executor("torch", mm_graph("torch"), 512).run(x))
        ref = out(executor("jax", mm_graph("jax"), 512).run(
            jnp.asarray(x), device_loop=True))
        np.testing.assert_array_equal(got, want)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(np.sign(got), np.sign(ref))
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_vr_graph_with_downstream_segment_and_fork(self):
        """A fixed-rate branch beside the variable-rate block (values cross
        from the piece before the push to the piece after it) and a block
        and a sink behind it (emission pieces): equal to the eager run,
        sink captures included, over two runs."""
        def build():
            fir = tfilt.FirFilter(1, np.ones(3, np.float32) / 3, impl="mxu")
            mm = tdb.ClockRecoveryMMFF(4, 0.25e-4, 0.5, 0.01)
            g = grtpu_torch.Graph()
            pin = g.add_input(grtpu_torch.Port(torch.float32))
            o0 = g.add_output(grtpu_torch.Port(torch.uint8))
            o1 = g.add_output(grtpu_torch.Port(torch.float32))
            sink = tgen.VectorSink(torch.float32)
            slicer = tdb.BinarySlicer()
            g.connect(pin, fir, mm, slicer, o0)
            g.connect(mm, sink)
            g.connect(fir, tgen.MultiplyConst(2.0), o1)
            return g, sink

        x = nrz(seed=2)
        (ga, sa), (gb, sb) = build(), build()
        eager, loop = executor("torch", ga, 512), executor("torch", gb, 512)
        for _ in range(2):
            want = [out(v) for v in eager.run(x)]
            got = [out(v) for v in loop.run(x, device_loop=True)]
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_, w_)
            np.testing.assert_array_equal(out(sb.captured[0]),
                                          out(sa.captured[0]))
        assert len(want[0]) > 100

    def test_nested_variable_rate(self):
        """A variable-rate block inside another's downstream segment
        (SkipHead -> Head, both compact): the inner push is read inside the
        outer emission; equal to the eager run."""
        def build():
            return chain("torch", [tstream.SkipHead(100, compact=True),
                                   tstream.Head(700, compact=True),
                                   tgen.AddConst(1.0)])

        x = np.arange(1024, dtype=np.float32)
        want = out(executor("torch", build(), 256).run(x))
        got = out(executor("torch", build(), 256).run(x, device_loop=True))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:3], [101.0, 102.0, 103.0])

    def test_source_driven_steps(self):
        """A graph without input pads (grtpu's executor.py:751-754):
        VectorSource(repeat) -> FirFilter for steps= chunks, twice; equal to
        the eager run, and to grtpu's device_loop run within 1e-5."""
        data = np.random.RandomState(3).randn(300).astype(np.float32)

        def build(kind):
            pkg, filt, gen = PKGS[kind][:3]
            g = pkg.Graph()
            o = g.add_output(pkg.Port(PKGS[kind][5]))
            g.connect(gen.VectorSource(data, repeat=True),
                      filt.FirFilter(2, fir_specs(3)[1][1], "fff",
                                     impl="mxu"), o)
            return g

        eager = executor("torch", build("torch"), 256)
        loop = executor("torch", build("torch"), 256)
        ref = executor("jax", build("jax"), 256)
        for _ in range(2):
            got = out(loop.run(steps=5, device_loop=True))
            np.testing.assert_array_equal(got, out(eager.run(steps=5)))
            assert got.shape == (5 * 128,)
            assert rel(got, out(ref.run(steps=5, device_loop=True))) < 1e-5

    def test_signal_source_equals_eager(self):
        """The NCO's carried phase through the static buffers: SigSource
        under device_loop equals the eager run exactly."""
        def build():
            g = grtpu_torch.Graph()
            o = g.add_output(grtpu_torch.Port(torch.complex64))
            g.connect(tanalog.SigSource(8000.0, "complex", 440.0, 0.5,
                                        dtype=torch.complex64),
                      tstream.Copy(torch.complex64), o)
            return g

        eager, loop = executor("torch", build(), 256), executor(
            "torch", build(), 256)
        for _ in range(2):
            np.testing.assert_array_equal(
                out(loop.run(steps=3, device_loop=True)),
                out(eager.run(steps=3)))

    def test_noise_source_replays_the_eager_stream(self):
        ex = [executor("torch", g, 256) for g in (
            self._noise_graph(), self._noise_graph())]
        np.testing.assert_array_equal(
            out(ex[1].run(steps=4, device_loop=True)), out(ex[0].run(steps=4)))

    @staticmethod
    def _noise_graph():
        g = grtpu_torch.Graph()
        o = g.add_output(grtpu_torch.Port(torch.complex64))
        g.connect(tgen.NoiseSource("gaussian", 0.5, 7, dtype=torch.complex64),
                  tstream.Copy(torch.complex64), o)
        return g

    def test_held_state_preserved(self):
        """grtpu's test_runtime.py:519-540: a state the caller holds stays
        valid and unchanged through a device_loop run."""
        def build():
            return chain("torch", [tgen.AddConst(1.0), tfilt.FirFilter(
                1, np.ones(4, np.float32), impl="mxu")])

        ex, twin = executor("torch", build(), 64), executor("torch", build(), 64)
        for e in (ex, twin):
            e.run(np.ones(64, np.float32))
        held = ex.state
        before = {k: v.clone() for k, v in held["tails"].items()}
        x = np.arange(256, dtype=np.float32)
        y = ex.run(x, device_loop=True)
        for k, v in held["tails"].items():
            assert torch.equal(v, before[k])
        assert ex.state["tails"] is not held["tails"]
        np.testing.assert_array_equal(out(y), out(twin.run(x)))
        np.testing.assert_array_equal(out(y)[:3], [7.0, 7.0, 8.0])

    def test_step_interleaves_with_device_loop(self):
        """step(), eager runs and device_loop runs share the carried state:
        any interleaving equals one eager stream."""
        specs = fir_specs(5)
        x = np.random.RandomState(5).randn(6 * 128).astype(np.float32)
        want = out(executor("torch", fir_graph("torch", specs), 128).run(x))
        ex = executor("torch", fir_graph("torch", specs), 128)
        parts = [out(ex.run(x[:256], device_loop=True)),
                 out(ex.step(x[256:384])[0][0]),
                 out(ex.run(x[384:640])),
                 out(ex.run(x[640:], device_loop=True))]
        np.testing.assert_array_equal(np.concatenate(parts), want)

    @pytest.mark.parametrize("graph", ["fir", "mm"])
    def test_checkpoint_mid_device_loop_resumes_eagerly(self, graph, tmp_path):
        """A checkpoint saved between two device_loop runs (FIFO not empty
        on the M&M graph) and loaded into a fresh executor that runs
        eagerly: the two halves equal one long run."""
        build = ((lambda: fir_graph("torch", fir_specs(6))) if graph == "fir"
                 else (lambda: mm_graph("torch")))
        x = (np.random.RandomState(6).randn(2048).astype(np.float32)
             if graph == "fir" else nrz(seed=6))
        want = out(executor("torch", build(), 256).run(x))
        ex = executor("torch", build(), 256)
        first = out(ex.run(x[:1024], device_loop=True))
        path = str(tmp_path / "ckpt.npz")
        ex.save_checkpoint(path)
        resumed = executor("torch", build(), 256)
        resumed.load_checkpoint(path)
        second = out(resumed.run(x[1024:]))
        np.testing.assert_array_equal(np.concatenate([first, second]), want)

    def test_stale_parameters_raise(self):
        blk = tfilt.FirFilter(1, np.ones(4, np.float32), impl="mxu")
        ex = executor("torch", chain("torch", [blk]), 8)
        ex.run(np.zeros(16, np.float32), device_loop=True)
        blk.set_taps(np.full(4, 2.0, np.float32))
        with pytest.raises(RuntimeError, match="changed after"):
            ex.run(np.zeros(16, np.float32), device_loop=True)

    def test_debug_taps_with_device_loop_raises(self):
        ex = executor("torch", chain("torch", [tgen.AddConst(1.0)]), 8,
                      debug_taps=True)
        with pytest.raises(ValueError, match="debug_taps"):
            ex.run(np.zeros(8, np.float32), device_loop=True)

    def test_source_graph_needs_steps(self):
        g = grtpu_torch.Graph()
        g.connect(tgen.NullSource(), tgen.NullSink())
        with pytest.raises(ValueError, match="steps="):
            executor("torch", g, 8).run(device_loop=True)

    def test_state_layout_change_raises(self):
        """A block whose state changes shape after the first step cannot
        ride fixed buffers: the second call of its piece raises."""
        class Growing(grtpu_torch.Block):
            def __init__(self):
                self.in_ports = (grtpu_torch.Port(torch.float32),)
                self.out_ports = (grtpu_torch.Port(torch.float32),)
                super().__init__()

            def init_state(self):
                return torch.zeros(1)

            def apply(self, state, x):
                return torch.cat([state, x[:1]]), x

        ex = executor("torch", chain("torch", [Growing()]), 8)
        with pytest.raises(ValueError, match="changed its shape"):
            ex.run(np.zeros(32, np.float32), device_loop=True)

    def test_vector_ports_and_sink_capture(self):
        """Items of vlen 4 through StreamToVector and a top-level sink: the
        sink's capture and the output equal the eager run's."""
        def build():
            sink = tgen.VectorSink(torch.float32, 4)
            g = grtpu_torch.Graph()
            pin = g.add_input(grtpu_torch.Port(torch.float32))
            o = g.add_output(grtpu_torch.Port(torch.float32, 4))
            s2v = tstream.StreamToVector(torch.float32, 4)
            g.connect(pin, tgen.AddConst(0.5), s2v, o)
            g.connect(s2v, sink)
            return g, sink

        x = np.arange(256, dtype=np.float32)
        (ga, sa), (gb, sb) = build(), build()
        want = out(executor("torch", ga, 64).run(x))
        got = out(executor("torch", gb, 64).run(x, device_loop=True))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (64, 4)
        np.testing.assert_array_equal(out(sb.captured[0]), out(sa.captured[0]))


class TestLaunchRecords:
    def test_launches_inside_a_record_count_at_replay(self):
        """A launch made while a graph is captured is not counted; each
        replay adds what the capture recorded."""
        before = dict(cuda_fir.launches)
        with cuda_fir.recording_launches() as rec:
            cuda_fir._check(0, "fir_decim_mma_fwd")
            cuda_fir._check(0, "fir_decim_mma_fwd")
        assert cuda_fir.launches == before
        assert rec["fir_decim_mma_fwd"] == 2 and sum(rec.values()) == 2
        for _ in range(3):
            cuda_fir.add_launches(rec)
        assert (cuda_fir.launches["fir_decim_mma_fwd"]
                == before["fir_decim_mma_fwd"] + 6)
        cuda_fir._check(0, "fir_tile_fwd")
        assert cuda_fir.launches["fir_tile_fwd"] == before["fir_tile_fwd"] + 1


# ------------------------------------------------------------------ fuse_firs
class TestFuseFirs:
    def _taps(self):
        rng = np.random.RandomState(10)
        return [(rng.randn(63) * 0.1).astype(np.float32),
                (rng.randn(33) * 0.1).astype(np.float32),
                (rng.randn(17) * 0.1).astype(np.float32)]

    def _build(self, kind, names=("a", "b", "c")):
        filt = PKGS[kind][1]
        t1, t2, t3 = self._taps()
        return chain(kind, [filt.FirFilter(1, t1, "fff", name=names[0]),
                            filt.FirFilter(1, t2, "fff", name=names[1]),
                            filt.FirFilter(2, t3, "fff", name=names[2])])

    def test_fused_chain_matches_grtpu(self):
        """tests/test_fir.py:464-495: one composed block, decimation 2,
        history 111; taps equal to grtpu's compose_taps; output within 1e-5
        of the unfused chain and of grtpu's fused run."""
        x = np.random.RandomState(11).randn(4096).astype(np.float32)
        plain = executor("torch", self._build("torch"), 1024)
        fused = executor("torch", self._build("torch"), 1024, fuse_firs=True)
        ref = executor("jax", self._build("jax"), 1024, fuse_firs=True)
        assert len(fused.flat.blocks) == 1
        blk = fused.flat.blocks[0]
        assert (blk.decim, blk.history, blk.name) == (2, 111, "a+b+c")
        assert blk.name == ref.flat.blocks[0].name
        np.testing.assert_allclose(blk.taps, j_compose(*self._taps()),
                                   atol=1e-6)
        np.testing.assert_array_equal(blk.taps, ref.flat.blocks[0].taps)
        y0, y1 = out(plain.run(x)), out(fused.run(x))
        assert rel(y1, y0) < 1e-5
        assert rel(y1, out(ref.run(jnp.asarray(x)))) < 1e-5

    def test_impl_follows_the_auto_rule(self):
        """The composed block takes grtpu's default impl: 'auto', so a
        decimating composed filter stays on the matmul path and a long
        decimation-1 one goes to the FFT path."""
        fused = executor("torch", self._build("torch"), 1024,
                         fuse_firs=True).flat.blocks[0]
        assert fused.impl == "mxu"
        filt = PKGS["torch"][1]
        g = chain("torch", [filt.FirFilter(1, np.ones(70, np.float32)),
                            filt.FirFilter(1, np.ones(70, np.float32))])
        assert executor("torch", g, 256, fuse_firs=True).flat.blocks[0].impl \
            == "fft"

    @pytest.mark.parametrize("case", ["decimating_first", "fork", "not_fir"])
    def test_pairs_that_do_not_fuse(self, case):
        """grtpu's pair rule: the upstream filter must not decimate, must
        feed only the downstream filter, the dtypes must line up, and both
        must be plain FirFilters."""
        taps = np.ones(5, np.float32)
        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        o0 = g.add_output(grtpu_torch.Port(torch.float32))
        if case == "decimating_first":
            g.connect(pin, tfilt.FirFilter(2, taps), tfilt.FirFilter(1, taps),
                      o0)
        elif case == "fork":
            a = tfilt.FirFilter(1, taps)
            g.connect(pin, a, tfilt.FirFilter(1, taps), o0)
            g.connect(a, g.add_output(grtpu_torch.Port(torch.float32)))
        else:
            g.connect(pin, tfilt.FftFilter(1, taps, "fff"),
                      tfilt.FirFilter(1, taps), o0)
        flat = g.flatten()
        assert len(fuse_fir_chains(flat).blocks) == len(flat.blocks)

    def test_runtime_imports_no_blocks(self):
        """The runtime package loads without grtpu_torch.blocks: the pass
        imports FirFilter when it runs."""
        import subprocess
        import sys

        code = ("import sys, grtpu_torch.runtime.executor, "
                "grtpu_torch.runtime.optimize, "
                "grtpu_torch.runtime.device_loop; "
                "print(any(m.startswith('grtpu_torch.blocks') "
                "for m in sys.modules))")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, check=True,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))
        assert res.stdout.strip() == "False"


# ------------------------------------------------------------------ debug_taps
class TestDebugTaps:
    def _build(self, kind):
        gen = PKGS[kind][2]
        pkg, f32 = PKGS[kind][0], PKGS[kind][5]
        g = pkg.Graph()
        pin = g.add_input(pkg.Port(f32))
        g.connect(pin, gen.AddConst(1.0, name="add"),
                  gen.MultiplyConst(2.0, name="mul"),
                  gen.VectorSink(name="sink"))
        return g

    def test_edge_data_matches_grtpu(self, tmp_path):
        """tests/test_runtime.py:344-363: the same edge_data keys as grtpu,
        arrays equal within 1e-6, dumped files of the same names and
        sizes."""
        x = np.arange(48, dtype=np.float32)
        ex = executor("torch", self._build("torch"), 16, debug_taps=True)
        ref = executor("jax", self._build("jax"), 16, debug_taps=True)
        ex.run(x)
        ref.run(jnp.asarray(x))
        assert sorted(ex.edge_data) == sorted(ref.edge_data)
        assert len(ex.edge_data) == 2
        for k, parts in ex.edge_data.items():
            got = torch.cat(parts).numpy()
            want = np.concatenate([np.asarray(p) for p in ref.edge_data[k]])
            np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_array_equal(
            torch.cat(ex.edge_data["add.0->mul.0"]).numpy(), x + 1)
        mine = ex.dump_debug_taps(str(tmp_path / "port"))
        theirs = ref.dump_debug_taps(str(tmp_path / "grtpu"))
        assert ({os.path.basename(p) for p in mine.values()}
                == {os.path.basename(p) for p in theirs.values()})
        for k, p in mine.items():
            assert os.path.getsize(p) == os.path.getsize(theirs[k]) > 0
            np.testing.assert_array_equal(np.fromfile(p, np.float32),
                                          np.fromfile(theirs[k], np.float32))

    def test_edges_accumulate_over_runs_and_skip_vr_segments(self):
        """Taps keep growing over runs, as grtpu's do; the edges behind a
        variable-rate block (inside its drain) are not exposed."""
        ex = executor("torch", self._build("torch"), 16, debug_taps=True)
        ex.run(np.zeros(32, np.float32))
        ex.run(np.zeros(16, np.float32))
        assert [len(p) for p in ex.edge_data.values()] == [3, 3]
        g = mm_graph("torch", tail=[lambda kind: tdb.BinarySlicer()])
        vr = executor("torch", g, 512, debug_taps=True)
        vr.run(nrz())
        assert vr.edge_data == {}

    def test_debug_taps_off_keeps_no_edges(self):
        ex = executor("torch", self._build("torch"), 16)
        ex.run(np.zeros(32, np.float32))
        assert ex.edge_data == {}
