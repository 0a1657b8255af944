"""grtpu_torch's MeshExecutor held against grtpu's and against its own
single-device executor.

The counterparts of tests/test_mesh_executor.py (and of the mesh cases of
tests/test_pmt_tags.py): graphs run on the port's 8-entry ``cpu`` mesh
against grtpu on its 8 virtual devices (tests/conftest.py), on the same
numpy input (local seeds), with grtpu's tolerances.  grtpu's mesh runs once
a case, in module-scoped fixtures.  A chan-sharded port mesh equals the
port's StreamExecutor per channel exactly (the loop route), and its
``device_loop`` run equals its stepwise run exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.runtime import mesh_executor as jmx  # noqa: E402
from grtpu.runtime.tags import Tag as JTag  # noqa: E402
from grtpu_torch.parallel.mesh import Mesh  # noqa: E402
from grtpu_torch.runtime import mesh_executor as tmx  # noqa: E402
from grtpu_torch.runtime.tags import Tag  # noqa: E402

PKG = {"jax": (grtpu, jnp), "torch": (grtpu_torch, torch)}


def jdevices(n):
    d = jax.devices()
    if len(d) < n:
        pytest.skip(f"needs {n} virtual devices, have {len(d)}")
    return d[:n]


def jmesh(shape, names=("time", "chan")):
    n = int(np.prod(shape))
    return JMesh(np.array(jdevices(n)).reshape(shape), names)


def tmesh(shape, names=("time", "chan")):
    dev = np.empty(int(np.prod(shape)), dtype=object)
    dev[:] = [torch.device("cpu")] * dev.size
    return Mesh(dev.reshape(shape), names)


def tmesh_lanes(shape, names=("time", "chan")):
    """A cpu mesh whose entries alternate, as a checkerboard, between two
    device objects, ``cpu`` and ``cpu:0``: a channel whose entry is not
    the executor's own device runs through a lane (a single-device
    executor of the graph on that device), and time shards pass the halo
    and the state from one entry's device to the next."""
    dev = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        dev[idx] = torch.device("cpu" if sum(idx) % 2 == 0 else "cpu:0")
    return Mesh(dev, names)


def out(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def mex(kind, g, mesh, nchan, chunk, **kw):
    if kind == "jax":
        return jmx.MeshExecutor(g, mesh, nchan, chunk_size=chunk,
                                donate=False, **kw)
    return tmx.MeshExecutor(g, mesh, nchan, chunk_size=chunk, **kw)


def single(kind, g, chunk):
    extra = {"device": "cpu"} if kind == "torch" else {"donate": False}
    return PKG[kind][0].StreamExecutor(g, chunk_size=chunk, **extra)


def wfm_graph(kind):
    pkg, mod = PKG[kind]
    fm = __import__(f"{pkg.__name__}.models.fm", fromlist=["WfmRcv"])
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(mod.complex64))
    pout = g.add_output(pkg.Port(mod.float32))
    g.connect(pin, fm.WfmRcv(256e3, 8), pout)
    return g


def mm_graph(kind, gain_mu=0.01, *limit):
    pkg, mod = PKG[kind]
    db = __import__(f"{pkg.__name__}.digital.blocks",
                    fromlist=["ClockRecoveryMMCC"])
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(mod.complex64))
    pout = g.add_output(pkg.Port(mod.complex64))
    g.connect(pin, db.ClockRecoveryMMCC(4, 0.25 * gain_mu ** 2, 0.5, gain_mu,
                                        *limit), pout)
    return g


def source_graph(kind):
    pkg, mod = PKG[kind]
    analog = __import__(f"{pkg.__name__}.blocks.analog", fromlist=["x"])
    filt = __import__(f"{pkg.__name__}.blocks.filter", fromlist=["x"])
    firdes = __import__(f"{pkg.__name__}.utils.firdes", fromlist=["x"])
    g = pkg.Graph()
    pout = g.add_output(pkg.Port(mod.float32))
    g.connect(analog.SigSource(32e3, "cos", 997.0),
              filt.FirFilter(2, firdes.low_pass(1.0, 32e3, 4e3, 2e3), "fff"),
              pout)
    return g


def branch_graph(kind):
    pkg, mod = PKG[kind]
    filt = __import__(f"{pkg.__name__}.blocks.filter", fromlist=["x"])
    gengen = __import__(f"{pkg.__name__}.blocks.gengen", fromlist=["x"])
    firdes = __import__(f"{pkg.__name__}.utils.firdes", fromlist=["x"])
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(mod.float32))
    pout = g.add_output(pkg.Port(mod.float32))
    f1 = filt.FirFilter(1, firdes.low_pass(1.0, 32e3, 4e3, 2e3), "fff",
                        impl="mxu")
    f2 = filt.FirFilter(1, firdes.high_pass(1.0, 32e3, 6e3, 2e3), "fff",
                        impl="mxu")
    add = gengen.Add(dtype=mod.float32, nin=2)
    g.connect(pin, f1, (add, 0))
    g.connect(pin, f2, (add, 1))
    g.connect(add, pout)
    return g


def wfm_input(seed, nchan, n):
    r = np.random.RandomState(seed)
    return (r.randn(nchan, n) + 1j * r.randn(nchan, n)).astype(np.complex64)


def mm_input(seed, nchan, n, sps=4):
    r = np.random.RandomState(seed)
    sig = np.zeros((nchan, n), np.complex64)
    for c in range(nchan):
        syms = r.choice([-1.0, 1.0], size=n // sps + 8)
        sig[c] = (np.repeat(syms, sps)[:n]
                  + 0.01 * r.randn(n)).astype(np.complex64)
    return sig


WFM_CHAN, WFM_CHUNK = 4, 2048


@pytest.fixture(scope="module")
def wfm_case():
    """grtpu's (4, 2) mesh over the WBFM graph: 4 channels, 3 chunks."""
    iq = wfm_input(0, WFM_CHAN, 3 * WFM_CHUNK)
    m = mex("jax", wfm_graph("jax"), jmx.make_mesh(8, jdevices(8)), WFM_CHAN,
            WFM_CHUNK)
    return iq, out(m.run(jnp.asarray(iq)))


def test_make_mesh_shapes():
    """make_mesh picks grtpu's axis sizes; with no devices given every
    entry is the card."""
    for n, time, want in ((8, None, (4, 2)), (4, None, (2, 2)),
                          (2, None, (1, 2)), (4, 1, (1, 4))):
        got = tmx.make_mesh(n, ["cpu"] * n, time=time)
        assert got.axis_names == ("time", "chan")
        assert got.devices.shape == want
        assert tuple(jmx.make_mesh(n, jdevices(n), time=time).devices.shape) \
            == want
    assert {str(d) for d in tmx.make_mesh(4).devices.flat} == {"cuda"}
    with pytest.raises(ValueError, match="does not divide"):
        tmx.make_mesh(6, ["cpu"] * 6, time=4)


def test_wfm_graph_time_chan_sharded_matches_single_device(wfm_case):
    """The WBFM chain built as a Graph on a 4x2 ('time', 'chan') mesh:
    halo overlap-save, de-emphasis chained shard-serially, state carried
    over 3 chunks; each channel equals its single-device run, and grtpu's
    mesh on the same input."""
    iq, y_j = wfm_case
    y = out(mex("torch", wfm_graph("torch"), tmesh((4, 2)), WFM_CHAN,
                WFM_CHUNK).run(iq))
    assert y.shape == (WFM_CHAN, 3 * WFM_CHUNK // 8)
    for c in range(WFM_CHAN):
        ref = out(single("torch", wfm_graph("torch"), WFM_CHUNK).run(iq[c]))
        np.testing.assert_allclose(y[c], ref, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(y, y_j, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (1, 1)])
def test_chan_sharded_wfm_equals_single_device_exactly(wfm_case, shape):
    """Channel sharding alone runs each channel through the single-device
    step (the loop route): torch.equal per channel, and grtpu's values."""
    iq, y_j = wfm_case
    y = mex("torch", wfm_graph("torch"), tmesh(shape), WFM_CHAN,
            WFM_CHUNK).run(iq)
    for c in range(WFM_CHAN):
        ref = single("torch", wfm_graph("torch"), WFM_CHUNK).run(iq[c])
        assert torch.equal(y[c], ref)
    np.testing.assert_allclose(out(y), y_j, atol=2e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def vr_case():
    """grtpu's chan-sharded clock recovery: 8 channels, 4 chunks."""
    nchan, chunk = 8, 1024
    sig = mm_input(1, nchan, 4 * chunk)
    m = mex("jax", mm_graph("jax"), JMesh(np.array(jdevices(8)), ("chan",)),
            nchan, chunk)
    return sig, [out(v) for v in m.run(jnp.asarray(sig))]


def test_clock_recovery_vr_chan_sharded(vr_case):
    """A variable-rate block (ClockRecoveryMMCC) channel-sharded: each
    channel's recovered stream equals its single-device run exactly, and
    grtpu's within its tolerance (1e-5) but for the symbols where the two
    packages' single-device loops already part (ROADMAP.md §3, "the exact
    complex M&M's interpolator dot": channels 6 and 7 of this input, 3
    symbols of 8192, each by less than 1e-3)."""
    sig, y_j = vr_case
    nchan, chunk = sig.shape[0], 1024
    y = mex("torch", mm_graph("torch"), tmesh((8,), ("chan",)), nchan,
            chunk).run(sig)
    assert isinstance(y, list) and len(y) == nchan
    apart = 0
    for c in range(nchan):
        ref = single("torch", mm_graph("torch"), chunk).run(sig[c])
        assert torch.equal(y[c], ref)
        assert y[c].shape == y_j[c].shape
        d = np.abs(out(y[c]) - y_j[c])
        assert d.max() < 1e-3
        apart += int((d > 1e-5).sum())
    assert apart <= 3


def test_stateful_source_time_sharded():
    """SigSource's carried NCO phase chains across time shards, so the
    waveform is the single continuous stream, not S restarted copies
    (grtpu's own bound: the phase wraps once a shard, not once a chunk)."""
    chunk = 1024
    y = out(mex("torch", source_graph("torch"), tmesh((4, 1)), 1,
                chunk).run(steps=3))[0]
    ref = out(single("torch", source_graph("torch"), chunk).run(steps=3))
    np.testing.assert_allclose(y, ref, atol=1e-4)
    y_j = out(mex("jax", source_graph("jax"), jmesh((4, 1)), 1,
                  chunk).run(steps=3))[0]
    np.testing.assert_allclose(y, y_j, atol=1e-4)


def test_multi_branch_graph_time_sharded():
    """Fan-out + join across time shards: per-edge halos stay independent
    and the join stays aligned."""
    nchan, chunk = 4, 512
    x = np.random.RandomState(3).randn(nchan, 2 * chunk).astype(np.float32)
    y = out(mex("torch", branch_graph("torch"), tmesh((2, 4)), nchan,
                chunk).run(x))
    for c in range(nchan):
        ref = out(single("torch", branch_graph("torch"), chunk).run(x[c]))
        np.testing.assert_allclose(y[c], ref, atol=1e-5)
    y_j = out(mex("jax", branch_graph("jax"), jmesh((2, 4)), nchan,
                  chunk).run(jnp.asarray(x)))
    np.testing.assert_allclose(y, y_j, atol=1e-5)


def test_vr_time_sharding_rejected():
    """Variable-rate consumption depends on the data; a static time split
    cannot be rate-aligned, and both executors say so."""
    for kind, mesh in (("jax", jmesh((2, 1))), ("torch", tmesh((2, 1)))):
        pkg, mod = PKG[kind]
        db = __import__(f"{pkg.__name__}.digital.blocks", fromlist=["x"])
        g = pkg.Graph()
        pin = g.add_input(pkg.Port(mod.float32))
        pout = g.add_output(pkg.Port(mod.float32))
        g.connect(pin, db.ClockRecoveryMMFF(4, 1e-4, 0.5, 0.01), pout)
        with pytest.raises(NotImplementedError, match="rate-aligned"):
            mex(kind, g, mesh, 2, 512)


@pytest.mark.parametrize("time,chunk,match", [
    (3, 1028, "not divisible by time axis size"),
    (4, 1028, "not a multiple of decim"),
    (4, 256, "smaller than history-1"),
])
def test_time_sharding_validation(time, chunk, match):
    """A chunk that the time axis does not divide, or whose per-shard input
    is not a multiple of a block's decimation or is shorter than its
    history, is refused with grtpu's message, by both executors."""
    for kind, mesh in (("jax", jmesh((time, 1))),
                       ("torch", tmesh((time, 1)))):
        pkg, mod = PKG[kind]
        filt = __import__(f"{pkg.__name__}.blocks.filter", fromlist=["x"])
        g = pkg.Graph()
        pin = g.add_input(pkg.Port(mod.float32))
        pout = g.add_output(pkg.Port(mod.float32))
        g.connect(pin, filt.FirFilter(4, np.ones(129, np.float32) / 129,
                                      "fff", impl="mxu"), pout)
        with pytest.raises(ValueError, match=match):
            mex(kind, g, mesh, 1, chunk)


@pytest.mark.parametrize("kind", ["single", "mesh"])
def test_stale_taps_guard(kind):
    """set_taps on a built executor raises, not silently running the old
    taps (the baked-constant trap), in both executors."""
    from grtpu_torch.blocks.filter import FirFilter

    g = grtpu_torch.Graph()
    pin = g.add_input(grtpu_torch.Port(torch.float32))
    pout = g.add_output(grtpu_torch.Port(torch.float32))
    f = FirFilter(1, np.ones(4, np.float32) / 4, "fff", impl="mxu")
    g.connect(pin, f, pout)
    if kind == "single":
        ex, x = single("torch", g, 256), np.zeros(256, np.float32)
    else:
        ex, x = mex("torch", g, tmesh((1, 2)), 2, 256), np.zeros(
            (2, 256), np.float32)
    ex.step(x)
    f.set_taps(np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="parameters changed"):
        ex.step(x)


@pytest.mark.parametrize("shape", [(4, 2), (1, 2), (2, 2)])
def test_device_loop_matches_stepwise_fixed_rate(wfm_case, shape):
    """run(device_loop=True): the whole mesh step from static buffers (one
    CUDA graph on a card) is torch.equal to the stepwise run, which equals
    grtpu's within its tolerance."""
    iq, y_j = wfm_case
    ref = mex("torch", wfm_graph("torch"), tmesh(shape), WFM_CHAN,
              WFM_CHUNK).run(iq)
    m = mex("torch", wfm_graph("torch"), tmesh(shape), WFM_CHAN, WFM_CHUNK)
    assert "one CUDA graph" in m.route
    got = m.run(iq, device_loop=True)
    assert torch.equal(got, ref)
    # a second run continues from the carried state, as the stepwise one
    assert torch.equal(m.run(iq, device_loop=True),
                       mex_continued(shape, iq))
    np.testing.assert_allclose(out(got), y_j, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_mesh_with_lanes_equals_single_device(wfm_case, shape):
    """Entries on two device objects: channels on the second one run
    through a lane built from the graph, time shards copy the halo and the
    chained state between the devices.  Each channel as on one device
    (torch.equal without time shards, grtpu's tolerance with them), grtpu's
    values, and the device_loop run equal to the stepwise run."""
    iq, y_j = wfm_case
    m = mex("torch", wfm_graph("torch"), tmesh_lanes(shape), WFM_CHAN,
            WFM_CHUNK)
    y = m.run(iq)
    assert bool(m._lanes) == (shape == (1, 2))
    for c in range(WFM_CHAN):
        ref = single("torch", wfm_graph("torch"), WFM_CHUNK).run(iq[c])
        if shape[0] == 1:
            assert torch.equal(y[c], ref)
        else:
            np.testing.assert_allclose(out(y[c]), out(ref), atol=2e-6,
                                       rtol=1e-5)
    np.testing.assert_allclose(out(y), y_j, atol=2e-6, rtol=1e-5)
    loop = mex("torch", wfm_graph("torch"), tmesh_lanes(shape), WFM_CHAN,
               WFM_CHUNK)
    assert torch.equal(loop.run(iq, device_loop=True), y)


def mex_continued(shape, iq):
    m = mex("torch", wfm_graph("torch"), tmesh(shape), WFM_CHAN, WFM_CHUNK)
    m.run(iq)
    return m.run(iq)


@pytest.fixture(scope="module")
def vr_loop_case():
    nchan, chunk, sps = 4, 1024, 4
    r = np.random.RandomState(6)
    n = 3 * chunk
    sym = (np.sign(r.randn(nchan, n // sps))
           + 1j * np.sign(r.randn(nchan, n // sps)))
    iq = np.repeat(sym, sps, axis=1).astype(np.complex64)
    m = mex("jax", mm_graph("jax", 0.175, 0.005),
            JMesh(np.array(jdevices(4)), ("chan",)), nchan, chunk)
    return iq, [out(v) for v in m.run(jnp.asarray(iq), device_loop=True)]


def test_device_loop_matches_stepwise_vr(vr_loop_case):
    """device_loop with a variable-rate block (a DeviceLoop a channel):
    per-chunk per-channel emission counts survive and the compacted streams
    equal the stepwise run exactly, and grtpu's within 1e-5 but where the
    single-device loops part (ROADMAP.md §3: here 1 symbol of 3072, by
    5.8e-5)."""
    iq, y_j = vr_loop_case
    nchan, chunk = iq.shape[0], 1024
    ref = mex("torch", mm_graph("torch", 0.175, 0.005),
              tmesh((4,), ("chan",)), nchan, chunk).run(iq)
    m = mex("torch", mm_graph("torch", 0.175, 0.005), tmesh((4,), ("chan",)),
            nchan, chunk)
    assert "DeviceLoop a channel" in m.route
    got = m.run(iq, device_loop=True)
    apart = 0
    for c in range(nchan):
        assert torch.equal(got[c], ref[c])
        d = np.abs(out(got[c]) - y_j[c])
        assert d.max() < 1e-3
        apart += int((d > 1e-5).sum())
    assert apart <= 1


def test_device_loop_vr_with_lanes(vr_loop_case):
    """A variable-rate block under device_loop on a mesh of two device
    objects: every second channel's DeviceLoop runs on a lane; the streams
    equal the stepwise mesh run and each channel's single-device run."""
    iq, _ = vr_loop_case
    nchan, chunk = iq.shape[0], 1024
    lanes = tmesh_lanes((4,), ("chan",))
    ref = mex("torch", mm_graph("torch", 0.175, 0.005), lanes, nchan,
              chunk).run(iq)
    m = mex("torch", mm_graph("torch", 0.175, 0.005), lanes, nchan, chunk)
    got = m.run(iq, device_loop=True)
    assert list(m._lanes) == [torch.device("cpu:0")]
    for c in range(nchan):
        assert torch.equal(got[c], ref[c])
        one = single("torch", mm_graph("torch", 0.175, 0.005), chunk).run(
            iq[c])
        assert torch.equal(ref[c], one)


def test_state_layout_is_grtpus(wfm_case):
    """Every state leaf carries a leading nchannels axis, as grtpu's mesh
    state does (the FIFO fills on the host); the checkpoint paths are the
    same."""
    from grtpu.runtime.executor import StreamExecutor as JEx

    jm = mex("jax", wfm_graph("jax"), jmesh((1, 2)), WFM_CHAN, 1024)
    tm = mex("torch", wfm_graph("torch"), tmesh((1, 2)), WFM_CHAN, 1024)
    jpaths = [(c, tuple(np.shape(a))) for c, a in
              JEx._canonical_leaf_paths(jm)]
    tpaths = [(c, tuple(a.shape)) for c, _, a in tm._canonical_leaf_paths()]
    assert jpaths == tpaths
    assert all(s[0] == WFM_CHAN for _, s in tpaths)


@pytest.fixture(scope="module")
def ckpt_case(tmp_path_factory):
    """grtpu's (1, 2) mesh: 2 chunks, a checkpoint, 2 more chunks."""
    nchan, chunk = 2, 1024
    iq = wfm_input(3, nchan, 4 * chunk)
    path = str(tmp_path_factory.mktemp("mesh") / "grtpu_mesh.npz")
    a = mex("jax", wfm_graph("jax"), jmesh((1, 2)), nchan, chunk)
    a.run(jnp.asarray(iq[:, :2 * chunk]))
    a.save_checkpoint(path)
    return iq, path, out(a.run(jnp.asarray(iq[:, 2 * chunk:])))


@pytest.mark.parametrize("resume", [(1, 2), (2, 2), (1, 1)])
def test_mesh_checkpoint_roundtrip(ckpt_case, tmp_path, resume):
    """save_checkpoint / load_checkpoint compose with MeshExecutor, and a
    checkpoint taken on a (1, 2) mesh restores on another mesh shape:
    the resumed stream equals the uninterrupted one (exactly on chan-only
    meshes), and grtpu's checkpoint of the same run restores too."""
    iq, jpath, y_j = ckpt_case
    nchan, chunk = 2, 1024
    a = mex("torch", wfm_graph("torch"), tmesh((1, 2)), nchan, chunk)
    a.run(iq[:, :2 * chunk])
    path = str(tmp_path / "mesh_ckpt.npz")
    a.save_checkpoint(path)
    y_ref = a.run(iq[:, 2 * chunk:])
    b = mex("torch", wfm_graph("torch"), tmesh(resume), nchan, chunk)
    b.load_checkpoint(path)
    y_res = b.run(iq[:, 2 * chunk:])
    if resume[0] == 1:
        assert torch.equal(y_res, y_ref)
    else:
        np.testing.assert_allclose(out(y_res), out(y_ref), atol=2e-6,
                                   rtol=1e-5)
    c = mex("torch", wfm_graph("torch"), tmesh(resume), nchan, chunk)
    c.load_checkpoint(jpath)
    np.testing.assert_allclose(out(c.run(iq[:, 2 * chunk:])), y_j,
                               atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(out(y_ref), y_j, atol=2e-6, rtol=1e-5)


# ----------------------------------------------------------------- tags
def burst_graph():
    from grtpu_torch.blocks.gengen import VectorSink
    from grtpu_torch.blocks.misc import BurstTagger

    g = grtpu_torch.Graph()
    psig = g.add_input(grtpu_torch.Port(torch.complex64))
    pmag = g.add_input(grtpu_torch.Port(torch.float32))
    bt = BurstTagger(threshold=0.5)
    s = VectorSink(dtype=torch.complex64, name="tagsink")
    g.connect(psig, (bt, 0))
    g.connect(pmag, (bt, 1))
    g.connect(bt, s)
    return g, s


def burst_input(seed, n=128):
    mag = np.zeros(n, np.float32)
    r = np.random.RandomState(seed)
    for _ in range(3):
        a = int(r.randint(0, n - 8))
        mag[a:a + int(r.randint(3, 20))] = 1.0
    return (np.arange(n) + 1j).astype(np.complex64), mag


@pytest.mark.parametrize("device_loop", [False, True])
def test_burst_tagger_mesh_matches_per_channel(device_loop):
    """A device_tags emitter on a chan-sharded mesh: each channel's plane
    holds the tags of that channel's single-device run, in both modes."""
    nchan = 4
    sigs, mags = zip(*[burst_input(seed=c) for c in range(nchan)])
    g, s = burst_graph()
    m = mex("torch", g, tmesh((1, 2)), nchan, 16)
    m.run(np.stack(sigs), np.stack(mags), device_loop=device_loop)
    for c in range(nchan):
        gc, sc = burst_graph()
        exc = single("torch", gc, 16)
        exc.run(sigs[c], mags[c])
        ref = sorted((t.offset, t.key, t.value)
                     for t in exc.sink_tags.get(sc.name, []))
        got = sorted((t.offset, t.key, t.value)
                     for t in m.sink_tags_chan(s.name, c))
        assert got == ref and len(ref) >= 2


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_input_tags_through_mesh(kind):
    """add_tags on a chan-sharded mesh: per-channel planes scale offsets
    through a decimating block independently per channel, as in grtpu."""
    pkg, mod = PKG[kind]
    stream = __import__(f"{pkg.__name__}.blocks.stream", fromlist=["x"])
    tag = JTag if kind == "jax" else Tag
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(mod.float32))
    pout = g.add_output(pkg.Port(mod.float32))
    g.connect(pin, stream.KeepOneInN(4, dtype=mod.float32), pout)
    mesh = jmesh((1, 2)) if kind == "jax" else tmesh((1, 2))
    m = mex(kind, g, mesh, 2, 64)
    m.add_tags(0, [tag(8, "a", 1)], channel=0)
    m.add_tags(0, [tag(100, "b", 2)], channel=1)
    m.run(np.zeros((2, 256), np.float32))
    assert [t.offset for t in m.pad_tags_chan(0, 0)] == [2]
    assert [t.offset for t in m.pad_tags_chan(0, 1)] == [25]
    assert m.pad_tags_chan(0, 0)[0].key == "a"
    assert m.pad_tags_chan(0, 1)[0].key == "b"


def test_tag_emitters_rejected_where_grtpu_rejects_them():
    """A time-sharded mesh refuses tag emitters (per-shard offsets would
    need rebasing), as grtpu's does."""
    g, _ = burst_graph()
    with pytest.raises(NotImplementedError, match="time-sharded"):
        mex("torch", g, tmesh((2, 1)), 1, 16)


def test_mesh_spanning_processes_is_refused():
    """The executor drives one process's entries; a mesh with entries of
    another process is refused before anything runs."""
    mesh = Mesh(np.array(["cpu"] * 2, dtype=object).reshape(1, 2),
                ("time", "chan"), processes=[[0, 1]])
    with pytest.raises(NotImplementedError, match="one process"):
        mex("torch", wfm_graph("torch"), mesh, 2, 1024)
