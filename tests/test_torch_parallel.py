"""grtpu_torch's parallel package held against grtpu's.

The counterparts of tests/test_parallel.py: the port's mesh of ``cpu``
entries (one process driving every shard) against grtpu on its 8 virtual
devices (tests/conftest.py), on the same numpy input (local seeds), with
grtpu's tolerances; grtpu's jitted programs run once a case (module-scoped
fixtures).  The two-process case runs tests/_torch_multihost_child.py
twice over gloo, with no JAX in the children.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, PartitionSpec as JP  # noqa: E402

from grtpu.parallel import halo as jhalo, pipeline as jpipe  # noqa: E402
from grtpu.parallel import sharded_fm as jfm  # noqa: E402
from grtpu_torch.ops.fir import fir_filter  # noqa: E402
from grtpu_torch.parallel import halo, mesh as tm, multihost  # noqa: E402
from grtpu_torch.parallel import pipeline, sharded_fm  # noqa: E402
from grtpu_torch.parallel.mesh import P  # noqa: E402


def jdevices(n):
    d = jax.devices()
    if len(d) < n:
        pytest.skip(f"needs {n} virtual devices, have {len(d)}")
    return d[:n]


def jmesh(shape, names):
    return JMesh(np.array(jdevices(int(np.prod(shape)))).reshape(shape),
                 names)


def tmesh(shape, names):
    dev = np.empty(int(np.prod(shape)), dtype=object)
    dev[:] = [torch.device("cpu")] * dev.size
    return tm.Mesh(dev.reshape(shape), names)


def jshard_map(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


# ------------------------------------------------------------ the mesh
def test_shard_unshard_roundtrip_and_specs():
    """shard splits by the spec and replicates over the unnamed axes;
    unshard joins it back, for every spec of a 2-D mesh."""
    m = tmesh((2, 4), ("time", "chan"))
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for spec in (P("chan", "time"), P("time", "chan"), P(None, "chan"),
                 P("chan"), P(("time", "chan")), P()):
        parts = tm.shard(x, m, spec)
        assert torch.equal(tm.unshard(parts, m, spec), x)
    parts = tm.shard(x, m, P("chan", "time"))
    assert torch.equal(parts[1, 2], x[4:6, 8:16])
    assert torch.equal(tm.shard(x, m, P(None, "chan"))[0, 3],
                       tm.shard(x, m, P(None, "chan"))[1, 3])
    with pytest.raises(ValueError, match="not divisible"):
        tm.shard(torch.zeros(6, 3), m, P("chan"))


@pytest.mark.parametrize("op", ["ppermute", "psum", "all_gather"])
def test_collectives_equal_jax(op):
    """ppermute (a ring), psum and all_gather along each axis of a (2, 4)
    mesh give jax's values inside shard_map (integer-valued floats, so the
    sums are exact in any order)."""
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 12)
    for axis in ("time", "chan"):
        n = {"time": 2, "chan": 4}[axis]
        ring = [(i, (i + 1) % n) for i in range(n)]
        jfn = {"ppermute": lambda v: jax.lax.ppermute(v, axis, ring),
               "psum": lambda v: jax.lax.psum(v, axis),
               "all_gather": lambda v: jax.lax.all_gather(v, axis)}[op]
        jm = jmesh((2, 4), ("time", "chan"))
        spec = JP("time", "chan")
        if op == "all_gather":
            want = np.asarray(jshard_map(lambda v: jfn(v)[None], jm, spec,
                                         JP(("time", "chan")))(x))
        else:
            want = np.asarray(jshard_map(jfn, jm, spec, spec)(x))
        m = tmesh((2, 4), ("time", "chan"))
        parts = tm.shard(x, m, P("time", "chan"))
        got = {"ppermute": lambda p: tm.ppermute(p, m, axis, ring),
               "psum": lambda p: tm.psum(p, m, axis),
               "all_gather": lambda p: tm.all_gather(p, m, axis)}[op](parts)
        if op == "all_gather":
            got = torch.cat([got[idx][None] for idx in m.entries()]).numpy()
            want = want.reshape(got.shape)
        else:
            got = tm.unshard(got, m, P("time", "chan")).numpy()
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ halo
@pytest.mark.parametrize("wrap", [False, True])
def test_halo_wrap_modes(wrap):
    """The first shard is zero-preloaded (or takes the last shard's tail
    with wrap); the others carry their left neighbour's tail; as grtpu."""
    x = np.arange(32, dtype=np.float32)
    m = tmesh((4,), ("t",))
    got = halo.ring_halo_left(tm.shard(x, m, P("t")), m, "t", 2, wrap=wrap)
    got = np.stack([got[(i,)].numpy() for i in range(4)])
    np.testing.assert_array_equal(got[0][:2], [30, 31] if wrap else [0, 0])
    np.testing.assert_array_equal(got[1][:2], [6, 7])
    np.testing.assert_array_equal(got[3][:2], [22, 23])
    want = jshard_map(lambda v: jhalo.ring_halo_left(v, "t", 2, wrap=wrap),
                      jmesh((4,), ("t",)), JP("t"), JP("t"))(jnp.asarray(x))
    np.testing.assert_array_equal(got.ravel(), np.asarray(want))


@pytest.mark.parametrize("decim", [1, 4])
def test_time_sharded_fir_matches_unsharded(decim):
    """shard_fir_filter over 4 time shards equals the unsharded FIR of the
    zero-preloaded stream, and grtpu's sharded FIR."""
    n, k = 1024, 33
    rng = np.random.RandomState(3)
    x = rng.randn(n).astype(np.float32)
    taps = rng.randn(k).astype(np.float32)
    m = tmesh((4,), ("t",))
    y = halo.shard_fir_filter(tm.shard(x, m, P("t")), taps, m, "t", decim)
    y = tm.unshard(y, m, P("t")).numpy()
    xh = np.concatenate([np.zeros(k - 1, np.float32), x])
    ref = fir_filter(torch.from_numpy(xh), taps, decim).numpy()
    np.testing.assert_allclose(y, ref, atol=2e-4)
    y_j = jshard_map(lambda v: jhalo.shard_fir_filter(v, jnp.asarray(taps),
                                                      "t", decim),
                     jmesh((4,), ("t",)), JP("t"), JP("t"))(jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(y_j), atol=2e-4)


# ------------------------------------------------------ sharded WBFM bank
def bank_input(nchan, t_total, steps, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(nchan, t_total) + 1j * rng.randn(nchan, t_total))
            .astype(np.complex64) for _ in range(steps)]


_JBANK = {}


def jbank_run(ndev, iqs):
    """grtpu's bank on make_mesh(ndev), each step in turn (one compile a
    mesh)."""
    key = (ndev, len(iqs), iqs[0].shape)
    if key not in _JBANK:
        mesh = jfm.make_mesh(ndev, jdevices(ndev))
        bank = jfm.ShardedWfmBank(mesh, quad_rate=64e3, audio_decim=4,
                                  nchannels=iqs[0].shape[0])
        f, st, outs = bank.jitted(), bank.init_state(), []
        for iq in iqs:
            a, st, p = f(jnp.asarray(iq), st)
            outs.append((np.asarray(a), np.asarray(st), float(p)))
        _JBANK[key] = outs
    return _JBANK[key]


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_wfm_bank_matches_single_device(ndev, steps):
    """The bank on a ('time', 'chan') mesh of 2, 4 and 8 entries equals the
    same bank on one entry, step after step with the state carried (the
    halo and the de-emphasis's affine prefix make it exact up to float32
    regrouping: grtpu's bounds), and grtpu's bank on the same mesh."""
    m = sharded_fm.make_mesh(ndev, ["cpu"] * ndev)
    assert dict(m.shape) == dict(jfm.make_mesh(ndev, jdevices(ndev)).shape)
    nchan = 2 * m.shape["chan"]
    t_total = m.shape["time"] * 256
    iqs = bank_input(nchan, t_total, steps, seed=ndev)
    bank = sharded_fm.ShardedWfmBank(m, quad_rate=64e3, audio_decim=4,
                                     nchannels=nchan)
    one = sharded_fm.ShardedWfmBank(tmesh((1, 1), ("time", "chan")),
                                    quad_rate=64e3, audio_decim=4,
                                    nchannels=nchan)
    f, f1 = bank.jitted(), one.step_fn()
    st, st1 = bank.init_state(), one.init_state()
    for i, (iq, (a_j, s_j, p_j)) in enumerate(zip(iqs, jbank_run(ndev, iqs))):
        a, st, p = f(torch.from_numpy(iq), st)
        a1, st1, p1 = f1(torch.from_numpy(iq), st1)
        assert a.shape == (nchan, t_total // 4) and np.isfinite(float(p))
        np.testing.assert_allclose(a.numpy(), a1.numpy(), atol=2e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(p), float(p1), rtol=1e-3)
        np.testing.assert_allclose(st.numpy(), st1.numpy(), atol=2e-4)
        np.testing.assert_allclose(a.numpy(), a_j, atol=2e-4)
        np.testing.assert_allclose(float(p), p_j, rtol=1e-3)
        np.testing.assert_allclose(st.numpy(), s_j, atol=2e-4)


def test_example_inputs_shapes():
    m = sharded_fm.make_mesh(4, ["cpu"] * 4)
    bank = sharded_fm.ShardedWfmBank(m, quad_rate=64e3, audio_decim=4,
                                     nchannels=4)
    iq, st = bank.example_inputs(t_per_shard=128, seed=1)
    assert iq.shape == (4, 256) and iq.dtype == torch.complex64
    assert st.shape == (2, 4)
    audio, st2, power = bank.step_fn()(iq, st)
    assert audio.shape == (4, 64) and np.isfinite(float(power))


# ------------------------------------------------------------ pipelines
@pytest.fixture(scope="module")
def pipe_case():
    S, K, chunk, M = 8, 17, 64, 6
    rng = np.random.RandomState(7)
    taps = rng.randn(S, K).astype(np.float32) / K
    x = rng.randn(M * chunk).astype(np.float32)
    pipe = jpipe.fir_chain_pipeline(jmesh((S,), ("stage",)), taps)
    y = np.asarray(pipe.run(jnp.asarray(x).reshape(M, chunk))).ravel()
    return taps, x, y, np.asarray(pipe.state)


def test_pipeline_chain_matches_sequential(pipe_case):
    """An 8-stage FIR pipeline over the 'stage' axis equals the same
    cascade run in sequence on one device, output and carried state, and
    grtpu's pipeline."""
    taps, x, y_j, state_j = pipe_case
    S, K = taps.shape
    M, chunk = 6, 64
    pipe = pipeline.fir_chain_pipeline(tmesh((S,), ("stage",)), taps)
    y = pipe.run(torch.from_numpy(x).reshape(M, chunk)).numpy().ravel()
    ref = x
    tails = []
    for s in range(S):
        xh = np.concatenate([np.zeros(K - 1, np.float32), ref])
        tails.append(xh[-(K - 1):])
        ref = fir_filter(torch.from_numpy(xh), taps[s], 1).numpy()
    np.testing.assert_allclose(y, ref, atol=1e-3)
    np.testing.assert_allclose(pipe.state.numpy(), np.stack(tails), atol=1e-5)
    np.testing.assert_allclose(y, y_j, atol=1e-4)
    np.testing.assert_allclose(pipe.state.numpy(), state_j, atol=1e-5)


def test_pipeline_state_continuity():
    """Two consecutive runs equal one run over the concatenated stream."""
    S, K, chunk, M = 4, 9, 32, 4
    rng = np.random.RandomState(9)
    taps = rng.randn(S, K).astype(np.float32) / K
    x = torch.from_numpy(rng.randn(2 * M * chunk).astype(np.float32))
    m = tmesh((S,), ("stage",))
    pipe = pipeline.fir_chain_pipeline(m, taps)
    y1 = pipe.run(x[:M * chunk].reshape(M, chunk))
    y2 = pipe.run(x[M * chunk:].reshape(M, chunk))
    whole = pipeline.fir_chain_pipeline(m, taps)
    yw = whole.run(x.reshape(2 * M, chunk))
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), yw.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(pipe.state.numpy(), whole.state.numpy(),
                               atol=1e-6)


def test_single_tap_stages():
    """K=1 stages are memoryless scalers; the pipeline keeps the rate-1
    contract."""
    S, chunk, M = 4, 32, 3
    pipe = pipeline.fir_chain_pipeline(tmesh((S,), ("stage",)),
                                       np.full((S, 1), 2.0, np.float32))
    x = torch.arange(M * chunk, dtype=torch.float32)
    y = pipe.run(x.reshape(M, chunk)).ravel()
    np.testing.assert_allclose(y.numpy(), x.numpy() * 16.0)


@pytest.mark.parametrize("decim", [1, 2])
def test_tap_parallel_fir(decim):
    """Tap-sharded FIR: the psum of per-shard partials equals the unsharded
    filter, and grtpu's tap-parallel FIR."""
    n_dev, K, N = 4, 64, 512
    rng = np.random.RandomState(11)
    taps = rng.randn(K).astype(np.float32)
    x = rng.randn(N + K - 1).astype(np.float32)
    m = tmesh((n_dev,), ("tp",))
    tl = tm.shard(taps, m, P("tp"))
    y = pipeline.tap_parallel_fir(torch.from_numpy(x), tl, m, "tp", decim)
    for idx in m.entries():
        assert torch.equal(y[idx], y[(0,)])
    ref = fir_filter(torch.from_numpy(x), taps, decim).numpy()
    np.testing.assert_allclose(y[(0,)].numpy(), ref, atol=3e-3)
    y_j = jshard_map(
        lambda xr, tloc: jpipe.tap_parallel_fir(xr, tloc[0], "tp", decim),
        jmesh((n_dev,), ("tp",)), (JP(), JP("tp")), JP())(
            jnp.asarray(x), jnp.asarray(taps.reshape(n_dev, K // n_dev)))
    np.testing.assert_allclose(y[(0,)].numpy(), np.asarray(y_j), atol=3e-3)


# ------------------------------------------------------- time-sharded M&M
@pytest.fixture(scope="module")
def mm_case():
    from grtpu.parallel.timeshard_vr import time_sharded_mm as jtsm

    rng = np.random.RandomState(0)
    sps, gm = 4, 0.175
    go = 0.25 * gm * gm
    syms = rng.choice([-1.0, 1.0], 20000)
    x = np.repeat(syms, sps).astype(np.float32)[2:]   # timing offset
    y_j, diag_j = jtsm(x, sps, go, gm, nshards=8, overlap_syms=512,
                       mesh=jmesh((8,), ("time",)))
    return x, sps, go, gm, np.asarray(y_j), diag_j


def test_time_sharded_mm_matches_continuous(mm_case):
    """One variable-rate stream over 8 time spans (run as one batch):
    every boundary splices at full overlap agreement, the kept symbols
    agree with the continuous loop past the settle region, and the splice
    is grtpu's: the same offsets and agreements, every decision equal.
    The symbol values part from grtpu's by up to 1e-3 (ROADMAP.md §3: the
    two packages' windowed loops part the same way on this stream run
    continuously, 1407 of 20009 symbols by up to 4.3e-4, from symbol
    1247 on, with every decision equal)."""
    from grtpu_torch.digital import loops
    from grtpu_torch.parallel.timeshard_vr import time_sharded_mm

    x, sps, go, gm, y_j, diag_j = mm_case
    W = 32
    L = sps + 2 * W + loops.NTAPS
    xp = np.concatenate([np.zeros(W, np.float32), x,
                         np.zeros(L + sps, np.float32)])
    st = loops.mm_windowed_init_state(float(sps), 0.5, device="cpu")
    y_ref = loops.clock_recovery_mm_ff_windowed(
        torch.from_numpy(xp), st, sps, go, gm, W=W)[0].numpy()
    y_sh, diag = time_sharded_mm(x, sps, go, gm, nshards=8, overlap_syms=512,
                                 mesh=tmesh((8,), ("time",)))
    assert min(diag["agreement"]) > 0.999, diag
    n = min(len(y_ref), len(y_sh)) - 8
    a = np.sign(y_ref[200:n])
    b = np.sign(y_sh[200: 200 + len(a)])
    assert (a == b).mean() > 0.999
    assert diag["offsets"] == diag_j["offsets"]
    np.testing.assert_allclose(diag["agreement"], diag_j["agreement"])
    assert y_sh.shape == y_j.shape
    np.testing.assert_array_equal(np.sign(y_sh), np.sign(y_j))
    np.testing.assert_allclose(y_sh, y_j, atol=1e-3)


def test_windowed_mm_batch_rows_equal_single_streams():
    """clock_recovery_mm_ff_windowed on a (B, n) batch: each row equals
    that stream run alone, bit for bit (the batch is what the time-sharded
    M&M runs)."""
    from grtpu_torch.digital import loops

    rng = np.random.RandomState(4)
    x = np.repeat(rng.choice([-1.0, 1.0], (3, 300)), 4, axis=1).astype(
        np.float32)[:, 1:] + 0.05 * rng.randn(3, 1199).astype(np.float32)
    st = loops.mm_windowed_init_state(4.0, 0.5, device="cpu")
    bst = loops.MMWinState(*(f.expand(3).clone() for f in st))
    yb, sb = loops.clock_recovery_mm_ff_windowed(
        torch.from_numpy(x), bst, 4, 0.01, 0.1, W=16)
    for r in range(3):
        y1, s1 = loops.clock_recovery_mm_ff_windowed(
            torch.from_numpy(x[r]), st, 4, 0.01, 0.1, W=16)
        assert torch.equal(yb[r], y1)
        for fb, f1 in zip(sb, s1):
            assert torch.equal(fb[r], f1)


# ------------------------------------------------------------ multihost
def test_host_shard_spec_covers_global():
    from grtpu.parallel.multihost import host_shard_spec as jspec

    m = tmesh((4, 2), ("time", "chan"))
    sl = multihost.host_shard_spec(m, P("chan", "time"), (8, 1024))
    assert sl == (slice(0, 8), slice(0, 1024))
    assert sl == jspec(jmesh((4, 2), ("time", "chan")), JP("chan", "time"),
                       (8, 1024))


def test_host_shard_spec_of_one_process_of_two():
    """With entries of another process in the mesh, this process's slice is
    the bounding box of its own entries, and feed_from_host fills only
    them."""
    dev = np.array(["cpu"] * 8, dtype=object).reshape(4, 2)
    m = tm.Mesh(dev, ("time", "chan"), processes=[[0, 1]] * 4)
    assert m.spans_processes
    sl = multihost.host_shard_spec(m, P("chan", "time"), (8, 1024))
    assert sl == (slice(0, 4), slice(0, 1024))
    x = np.arange(8 * 1024, dtype=np.float32).reshape(8, 1024)
    parts = multihost.feed_from_host(m, P("chan", "time"), x[sl], (8, 1024))
    for idx in m.entries():
        if idx[1] == 0:
            want = x[tm.entry_slices(m, P("chan", "time"), x.shape, idx)]
            np.testing.assert_array_equal(parts[idx].numpy(), want)
        else:
            assert parts[idx] is None
    with pytest.raises(ValueError, match="spans processes"):
        tm.unshard(parts, m, P("chan", "time"))
    with pytest.raises(RuntimeError, match="not initialized"):
        tm.psum(parts, m, "chan")


def test_feed_from_host_matches_shard():
    m = tmesh((4, 2), ("time", "chan"))
    x = np.arange(8 * 256, dtype=np.float32).reshape(8, 256)
    parts = multihost.feed_from_host(m, P("chan", "time"), x, (8, 256))
    ref = tm.shard(x, m, P("chan", "time"))
    for idx in m.entries():
        assert torch.equal(parts[idx], ref[idx])
    np.testing.assert_array_equal(
        tm.unshard(parts, m, P("chan", "time")).numpy(), x)


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_udp_ingest_feeds_sharded_wfm():
    """UDP 'antenna feed' -> per-process ingest -> the sharded WBFM bank
    consumes it; the samples arrive unchanged."""
    from grtpu_torch.io.udp import UdpSink, UdpSource

    m = sharded_fm.make_mesh(8, ["cpu"] * 8)
    nchan = 2 * m.shape["chan"]
    bank = sharded_fm.ShardedWfmBank(m, quad_rate=64e3, audio_decim=4,
                                     nchannels=nchan)
    t_total = m.shape["time"] * 256
    rng = np.random.RandomState(3)
    iq = (rng.randn(nchan, t_total)
          + 1j * rng.randn(nchan, t_total)).astype(np.complex64)
    src = UdpSource("127.0.0.1", 0, np.complex64, timeout=2.0)
    port = src.sock.getsockname()[1]
    snk = UdpSink("127.0.0.1", port, np.complex64)
    t = threading.Thread(target=lambda: snk.write_items(iq.ravel()))
    t.start()
    try:
        parts = multihost.udp_ingest_step(m, P("chan", "time"), src,
                                          nchan * t_total, (nchan, t_total))
    finally:
        t.join(timeout=10)
        snk.close()
        src.close()
    assert not t.is_alive() and parts is not None
    np.testing.assert_array_equal(
        tm.unshard(parts, m, P("chan", "time")).numpy(), iq)
    audio, st, power = bank.step_fn()(parts, bank.init_state())
    assert np.isfinite(float(power))
    ref, _, _ = bank.step_fn()(torch.from_numpy(iq), bank.init_state())
    assert torch.equal(audio, ref)


def test_two_process_ingest_and_collectives(tmp_path):
    """Two processes over gloo (tests/_torch_multihost_child.py): each
    ingests its half of the channels with feed_from_host onto its 4 mesh
    entries, and the step's normalization (a psum), a ring ppermute and an
    all_gather cross the process boundary.  Every local shard equals the
    single-process result (grtpu's bounds), computed by grtpu here."""
    from grtpu.ops.fir import fir_filter as jfir

    child = os.path.join(os.path.dirname(__file__), "_torch_multihost_child.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH",
                        "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, child, str(i), "2", str(port),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)[-3000:]
    assert all("OK jax_loaded=False" in o for o in outs), outs

    NCHAN, NSAMP, K = 8, 512, 16
    taps = (np.arange(1, K + 1) / (K * K)).astype(np.float32)
    full = np.sin(np.arange(NCHAN * (NSAMP + K - 1), dtype=np.float32)
                  .reshape(NCHAN, NSAMP + K - 1) * 0.01)

    @jax.jit
    def step(a):
        y = jax.vmap(lambda r: jfir(r, jnp.asarray(taps)))(a)
        p = jnp.mean(y * y)
        return y / jnp.sqrt(p + 1e-9)

    ref = np.asarray(step(full))
    for pid, rows in ((0, slice(0, 4)), (1, slice(4, 8))):
        got = np.load(tmp_path / f"mh_{pid}.npz")
        np.testing.assert_allclose(got["y"], ref[rows], rtol=2e-6, atol=2e-7)
        # ring ppermute over 'chan': entry c holds channel c-1's first sample
        firsts = full[:, 0]
        np.testing.assert_array_equal(
            got["perm"], np.roll(firsts, 1)[rows])
        np.testing.assert_array_equal(got["gathered"], np.stack(
            [firsts] * 4))
