"""grtpu_torch's variable-rate executor held against grtpu's on the CPU.

The scenarios of tests/test_vr_graph.py (chunked == full run, downstream
consumer, chunk-size invariance, complex VR, emission sizing, the VR-join
rejection, required_multiple), each built in both packages over the same
numpy input; the DMR 4FSK streaming graph
(QuadratureDemod -> matched RRC -> ClockRecoveryMMFF -> FourLevelSlicer) as
a whole; and checkpoints taken mid-stream with a non-empty FIFO, carried
from grtpu to the port and back.  Symbol streams agree to atol 1e-5;
decisions and emission counts exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu.blocks.analog as janalog  # noqa: E402
import grtpu.blocks.filter as jfilt  # noqa: E402
import grtpu.digital.blocks as jdb  # noqa: E402
import grtpu_torch  # noqa: E402
import grtpu_torch.blocks.analog as tanalog  # noqa: E402
import grtpu_torch.blocks.filter as tfilt  # noqa: E402
import grtpu_torch.digital.blocks as tdb  # noqa: E402
from grtpu_torch.digital import loops as tl  # noqa: E402
from grtpu_torch.digital.modems import Fsk4Modem  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

PKGS = {
    "jax": (grtpu, jdb, jfilt, janalog, jnp.float32, jnp.complex64, jnp.uint8),
    "torch": (grtpu_torch, tdb, tfilt, tanalog, torch.float32, torch.complex64,
              torch.uint8),
}
GO, GM = 0.25 * 0.175 ** 2, 0.175


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def cpu(pkg):
    """Keyword that keeps a grtpu_torch entry point on the CPU (its default
    device is the card); grtpu takes no such argument."""
    return {"device": "cpu"} if pkg is grtpu_torch else {}


def _nrz(nsym, sps, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym)
    return bits, np.repeat(bits * 2.0 - 1.0, sps).astype(np.float32)


def mm_graph(kind, tail=(), chunk=1000, cplx=False, **kw):
    """pad -> ClockRecoveryMM{FF,CC}(omega 4) -> *tail -> pad."""
    pkg, db, _, _, f32, c64, u8 = PKGS[kind]
    dt = c64 if cplx else f32
    mm = (db.ClockRecoveryMMCC if cplx else db.ClockRecoveryMMFF)(
        omega=4, gain_omega=GO, mu=0.5, gain_mu=GM)
    blocks = [b(kind) for b in tail]
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(dt))
    pout = g.add_output(pkg.Port(blocks[-1].out_ports[0].dtype if blocks
                                 else dt))
    g.connect(pin, mm, *blocks, pout)
    return pkg.StreamExecutor(g, chunk_size=chunk, **kw, **cpu(pkg)), mm


def hand_mm(x, mm, cplx=False):
    """Port's full-stream single call: the executor's halo of history-1
    zeros, the op once over everything."""
    xp = torch.cat([torch.zeros(mm.history - 1, dtype=torch.complex64 if cplx
                                else torch.float32), torch.from_numpy(x)])
    fn = tl.clock_recovery_mm_cc if cplx else tl.clock_recovery_mm_ff
    ys, nv, _ = fn(xp, mm.init_state(), mm.omega, mm.gain_omega, mm.gain_mu,
                   mm.omega_relative_limit)
    return ys[: int(nv)].numpy()


class TestMMFirstClass:
    def test_vr_block_to_pad_chunked_equals_full_run(self):
        _, x = _nrz(1500, 4, seed=1)
        ex, mm = mm_graph("torch")
        got = out(ex.run(x))
        want = hand_mm(x, mm)
        assert len(got) > 1200 and len(got) <= len(want)
        np.testing.assert_array_equal(got, want[: len(got)])
        assert len(want) - len(got) < ex.vr_emit[mm.uid] + 2
        ref = out(mm_graph("jax")[0].run(x))
        assert ref.shape == got.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_vr_with_downstream_consumer(self):
        bits, x = _nrz(1000, 4, seed=2)
        res = {}
        for kind in PKGS:
            ex, mm = mm_graph(kind, [lambda k: PKGS[k][1].BinarySlicer()],
                              chunk=500)
            res[kind] = out(ex.run(x))
        got = res["torch"]
        np.testing.assert_array_equal(got, res["jax"])
        want = (hand_mm(x, mm) >= 0).astype(np.uint8)
        np.testing.assert_array_equal(got, want[: len(got)])
        dec = got.astype(np.int32)
        best = max(((dec[50:900] == bits[50 - lag:900 - lag]).mean(), lag)
                   for lag in range(8))
        assert best[0] > 0.999, best

    def test_chunk_size_invariance(self):
        _, x = _nrz(800, 4, seed=3)
        outs = [out(mm_graph("torch", chunk=cs)[0].run(x))
                for cs in (250, 640, 1500)]
        n = min(len(o) for o in outs)
        assert n > 600
        np.testing.assert_array_equal(outs[0][:n], outs[1][:n])
        np.testing.assert_array_equal(outs[0][:n], outs[2][:n])

    def test_vr_complex(self):
        rng = np.random.default_rng(4)
        syms = (rng.integers(0, 2, 600) * 2 - 1) + 1j * (
            rng.integers(0, 2, 600) * 2 - 1)
        x = (np.repeat(syms, 4) / np.sqrt(2)).astype(np.complex64)
        ex, mm = mm_graph("torch", chunk=400, cplx=True)
        got = out(ex.run(x))
        want = hand_mm(x, mm, cplx=True)
        assert len(got) > 500
        np.testing.assert_array_equal(got, want[: len(got)])
        ref = out(mm_graph("jax", chunk=400, cplx=True)[0].run(x))
        np.testing.assert_allclose(got, ref, atol=1e-5)


class TestVrRateLogic:
    def test_emission_size_respects_downstream_decimation(self):
        _, x = _nrz(1000, 4, seed=5)
        taps = firdes.low_pass(1.0, 1.0, 0.2, 0.1)
        res = {}
        for kind in PKGS:
            ex, mm = mm_graph(kind, [lambda k: PKGS[k][2].FirFilter(
                5, taps, "fff", impl="mxu")], chunk=500)
            assert ex.vr_emit[mm.uid] % 5 == 0
            res[kind] = (out(ex.run(x)), ex.vr_emit[mm.uid],
                         ex.vr_cap[mm.uid], ex.vr_total_rows[mm.uid])
        got, ref = res["torch"], res["jax"]
        assert got[1:] == ref[1:]
        assert got[0].shape == ref[0].shape and len(got[0]) > 150
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5)

    def test_vr_join_rejected(self):
        class Add2(grtpu_torch.Block):
            def __init__(self):
                self.in_ports = (grtpu_torch.Port(torch.float32),) * 2
                self.out_ports = (grtpu_torch.Port(torch.float32),)
                super().__init__()

            def apply(self, state, a, b):
                return state, a + b

        mm = tdb.ClockRecoveryMMFF(omega=4, gain_omega=GO, mu=0.5, gain_mu=GM)
        add = Add2()
        g = grtpu_torch.Graph()
        pin = g.add_input(grtpu_torch.Port(torch.float32))
        pout = g.add_output(grtpu_torch.Port(torch.float32))
        g.connect(pin, mm, (add, 0))
        g.connect(pin, (add, 1))
        g.connect(add, pout)
        with pytest.raises(ValueError, match="variable-rate"):
            grtpu_torch.StreamExecutor(g, chunk_size=512, device="cpu")

    def test_required_multiple_exact(self):
        taps = firdes.low_pass(1.0, 1.0, 0.2, 0.1)
        x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
        res = {}
        for kind, (pkg, _, filt, _, f32, _, _) in PKGS.items():
            g = pkg.Graph()
            pin = g.add_input(pkg.Port(f32))
            pout = g.add_output(pkg.Port(f32))
            g.connect(pin, filt.InterpFirFilter(3, taps, "fff"),
                      filt.FirFilter(2, taps, "fff", impl="mxu"), pout)
            ex = pkg.StreamExecutor(g, chunk_size=2048, **cpu(pkg))
            assert ex.required_multiple() == 2
            res[kind] = out(ex.run(x))
        assert res["torch"].shape == (4096 * 3 // 2,)
        np.testing.assert_allclose(res["torch"], res["jax"], atol=1e-5)


SPS = 10


def dmr_graph(kind, chunk=4096):
    """QuadratureDemod(1/sensitivity) -> FirFilter(rx RRC / sps) ->
    ClockRecoveryMMFF(omega=10, gain_mu=0.05, limit 0.005) ->
    FourLevelSlicer(scale=3)."""
    pkg, db, filt, analog, _, c64, u8 = PKGS[kind]
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(c64))
    pout = g.add_output(pkg.Port(u8))
    g.connect(pin, analog.QuadratureDemod(1.0 / modem.sensitivity),
              filt.FirFilter(1, modem.rx_taps / SPS, "fff", impl="mxu"),
              db.ClockRecoveryMMFF(omega=SPS, gain_omega=0.25 * 0.05 ** 2,
                                   mu=0.5, gain_mu=0.05,
                                   omega_relative_limit=0.005),
              db.FourLevelSlicer(scale=3.0), pout)
    return pkg.StreamExecutor(g, chunk_size=chunk, **cpu(pkg))


def dmr_stream(nsym, seed=0):
    modem = Fsk4Modem(samples_per_symbol=SPS, device="cpu")
    dibits = np.random.RandomState(seed).randint(0, 4, nsym).astype(np.uint8)
    return dibits, modem.modulate(dibits).numpy()


class TestDmrStream:
    def test_dmr_graph_matches_grtpu(self):
        dibits, x = dmr_stream(1300, seed=1)
        res = {}
        for kind in PKGS:
            ex = dmr_graph(kind, chunk=2048)
            res[kind] = (out(ex.run(x)), len(ex.vr_blocks))
        got, ref = res["torch"][0], res["jax"][0]
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert len(got) > 1200
        np.testing.assert_array_equal(got, ref)
        # and the dibits are the ones sent (after the acquisition settle)
        ser = min((got[200 + s: 1200 + s] != dibits[200:1200]).mean()
                  for s in range(16))
        assert ser < 0.005, ser

    @pytest.mark.parametrize("first", ["jax", "torch"])
    def test_checkpoint_crosses_packages(self, first, tmp_path):
        """A DMR graph checkpointed mid-stream by one package, with a
        non-empty FIFO and a live MMState, resumes in the other with the
        identical remaining dibits."""
        second = "torch" if first == "jax" else "jax"
        _, x = dmr_stream(900, seed=2)
        head, rest = x[:4096], x[4096:]
        a = dmr_graph(first, chunk=2048)
        a.run(head)
        path = str(tmp_path / "dmr.npz")
        a.save_checkpoint(path)
        saved = np.load(path)
        paths = list(saved["__paths__"])
        fill = next(saved[f"arr_{j}"] for j, p in enumerate(paths)
                    if p.startswith("fifo/") and p.endswith("/1"))
        assert fill.dtype == np.int32 and 0 < int(fill) < a.vr_emit[
            a.vr_blocks[0].uid]
        assert sum(p.endswith("ClockRecoveryMMFF:d1i1h21/None")
                   for p in paths) == 4
        want = out(a.run(rest))
        b = dmr_graph(second, chunk=2048)
        b.load_checkpoint(path)
        got = out(b.run(rest))
        assert len(want) > 300
        np.testing.assert_array_equal(got, want)


class TestStepContract:
    def test_step_emission_buffers_and_stream(self):
        _, x = _nrz(600, 4, seed=6)
        ex, mm = mm_graph("torch", chunk=600)
        pads, caps = ex.step(x[:600])
        rows = ex.vr_total_rows[mm.uid]
        assert pads[0].shape == (rows, ex.vr_emit[mm.uid])
        n = caps["__vr_counts__"][mm.name]
        assert 0 < n <= rows
        ex2, _ = mm_graph("torch", chunk=600)
        parts = [out(y) for y in ex2.stream(x[i:i + 600]
                                            for i in range(0, 2400, 600))]
        whole = out(mm_graph("torch", chunk=600)[0].run(x))
        np.testing.assert_array_equal(np.concatenate(parts), whole)
        np.testing.assert_array_equal(parts[0], out(pads[0][:n]).reshape(-1))
