"""grtpu_torch's messages, PMTs, stream tags and TopBlock held against grtpu.

The scenarios of tests/test_pmt_tags.py (without the mesh, tagged-file-sink
and BurstTagger cases, which wait for their slices) and of
tests/test_apps.py::TestTopBlock, each run through both packages on the
same numpy input (local seeds).  Tags are compared as sorted (offset, key,
value, source) tuples, exactly; every executor case runs eagerly and under
``run(device_loop=True)`` (on the CPU the static-buffer step without a
graph), and both must equal grtpu's.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import gengen as jgen, stream as jstream  # noqa: E402
from grtpu.digital import correlate as jcorr  # noqa: E402
from grtpu.digital import packet_blocks as jpb  # noqa: E402
from grtpu.runtime import msg as jmsg, pmt as jpmt, tags as jtags  # noqa: E402
from grtpu.runtime import top_block as jtop  # noqa: E402
from grtpu_torch.blocks import gengen as tgen, stream as tstream  # noqa: E402
from grtpu_torch.digital import correlate as tcorr  # noqa: E402
from grtpu_torch.digital import packet_blocks as tpb  # noqa: E402
from grtpu_torch.runtime import msg as tmsg, pmt as tpmt, tags as ttags  # noqa: E402
from grtpu_torch.runtime import top_block as ttop  # noqa: E402

PKG = {
    "j": dict(pkg=grtpu, lib=jnp, gen=jgen, stream=jstream, corr=jcorr,
              pb=jpb, tags=jtags, top=jtop, msg=jmsg),
    "t": dict(pkg=grtpu_torch, lib=torch, gen=tgen, stream=tstream,
              corr=tcorr, pb=tpb, tags=ttags, top=ttop, msg=tmsg),
}
MODES = ["eager", "device_loop"]


def executor(kind, g, chunk, **kw):
    m = PKG[kind]
    if kind == "j":
        return m["pkg"].StreamExecutor(g, chunk_size=chunk, donate=False, **kw)
    return m["pkg"].StreamExecutor(g, chunk_size=chunk, device="cpu", **kw)


def run(kind, ex, *xs, mode="eager"):
    if kind == "j":
        return ex.run(*[jnp.asarray(x) for x in xs])
    return ex.run(*xs, device_loop=mode == "device_loop")


def tagset(tags):
    return sorted((t.offset, t.key, repr(t.value), t.srcid) for t in tags)


def sink_tags(ex, name):
    return tagset(ex.sink_tags.get(name, []))


# ------------------------------------------------------------------- PMT
PMT_VALUES = [42, 3.14, 1 + 2j, "symbol", True, None,
              ("car", {"k": [1, 2, 3]}),
              np.arange(100, dtype=np.complex64) * (1 - 1j),
              np.arange(12, dtype=np.int16).reshape(3, 4)]


@pytest.mark.parametrize("i", range(len(PMT_VALUES)))
def test_pmt_serialize_is_byte_identical_both_ways(i):
    """The port's copy serializes to grtpu's bytes, and each package reads
    the other's."""
    v = PMT_VALUES[i]
    blob_t, blob_j = tpmt.serialize(v), jpmt.serialize(v)
    assert blob_t == blob_j
    for got in (tpmt.deserialize(blob_j), jpmt.deserialize(blob_t)):
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v)
            assert got.dtype == v.dtype and got.shape == v.shape
        else:
            assert got == v


def test_pmt_api_matches_grtpu():
    """Constructors, predicates, pairs, dicts and uniform vectors
    (TestPmt's cases) give what grtpu's give; garbage is refused."""
    for p in (tpmt, jpmt):
        assert p.is_integer(p.from_long(7))
        assert p.is_real(p.from_double(2.5))
        assert p.is_complex(p.from_complex(1 + 2j))
        assert p.is_symbol(p.string_to_symbol("freq"))
        assert p.is_bool(p.PMT_T) and p.PMT_T and p.is_null(p.PMT_NIL)
        pr = p.cons(p.string_to_symbol("key"), p.from_long(5))
        assert p.is_pair(pr) and p.car(pr) == "key" and p.cdr(pr) == 5
        d = p.dict_add(p.make_dict(), "freq", 100e6)
        assert p.dict_ref(d, "freq") == 100e6
        assert p.dict_ref(d, "gain", -1) == -1
        v = p.make_c32vector(8, 1 + 1j)
        assert p.is_uniform_vector(v) and p.length(v) == 8
        with pytest.raises(ValueError):
            p.deserialize(b"NOTAPMT")
    public = {n for n in vars(jpmt) if not n.startswith("_")}
    assert public <= set(vars(tpmt))


# ------------------------------------------------------------------- messages
def test_msg_queue_and_typed_header():
    """gr_msg_queue semantics and the fork's typed gr_message header
    (kind / arg1 / arg2), in both packages alike."""
    for m in (tmsg, jmsg):
        q = m.MsgQueue(limit=4)
        assert q.empty_p()
        q.insert_tail(m.Message(payload=b"a"))
        q.insert_tail(m.Message(payload=b"b", kind=3, arg1=1.5))
        assert q.count() == 2
        assert q.delete_head().to_string() == b"a"
        m2 = q.delete_head_nowait()
        assert (m2.kind, m2.arg1, m2.arg2) == (3, 1.5, 0.0)
        assert q.delete_head_nowait() is None
        m.send(m.MsgAccepterMsgQ(q), m.Message(payload=b"ping"))
        assert q.delete_head().to_string() == b"ping"
        typed = m.Message(payload=np.arange(4, dtype=np.float32).tobytes(),
                          kind=7, arg1=2.0, arg2=3.0)
        assert typed.kind == 7 and typed.length() == 16
        s = m.message_from_string(b"xyz", kind=2, arg1=0.5, arg2=-1.0)
        assert (s.to_string(), s.kind, s.arg1, s.arg2) == (b"xyz", 2, 0.5, -1.0)
    assert [f.name for f in tmsg.Message.__dataclass_fields__.values()] == \
        [f.name for f in jmsg.Message.__dataclass_fields__.values()]


def test_queue_watcher_delivers_and_stops():
    """The watcher thread drains the queue into its callback; stop() joins
    it within its timeout."""
    q = tmsg.MsgQueue()
    got, done = [], threading.Event()

    def cb(msg):
        got.append((msg.to_string(), msg.kind))
        if len(got) == 3:
            done.set()

    w = tmsg.QueueWatcher(q, cb)
    try:
        for i in range(3):
            q.insert_tail(tmsg.Message(payload=b"m%d" % i, kind=i))
        assert done.wait(10)
    finally:
        w.stop(timeout=10)
    assert not w.thread.is_alive()
    assert got == [(b"m0", 0), (b"m1", 1), (b"m2", 2)]


# ------------------------------------------------------------------- tags
def test_tag_helpers_match_grtpu():
    tags_j = [jtags.Tag(i * 10, "t", i) for i in range(10)]
    tags_t = [ttags.Tag(i * 10, "t", i) for i in range(10)]
    for r in (0.25, 1.0, 3.0):
        assert tagset(ttags.propagate_tags(tags_t, r)) == \
            tagset(jtags.propagate_tags(tags_j, r))
    assert [t.offset for t in ttags.tags_in_window(tags_t, 25, 55)] == \
        [t.offset for t in jtags.tags_in_window(tags_j, 25, 55)] == [30, 40, 50]


def _two_port(kind, policy):
    m = PKG[kind]
    f32 = m["lib"].float32

    class TwoPort(m["pkg"].Block):
        tag_propagation = policy
        in_ports = (m["pkg"].Port(f32), m["pkg"].Port(f32))
        out_ports = (m["pkg"].Port(f32), m["pkg"].Port(f32))

        def apply(self, state, a, b):
            return state, (a, b)

    g = m["pkg"].Graph()
    p0 = g.add_input(m["pkg"].Port(f32))
    p1 = g.add_input(m["pkg"].Port(f32))
    blk = TwoPort(name="two")
    s0, s1 = m["gen"].VectorSink(name="s0"), m["gen"].VectorSink(name="s1")
    g.connect(p0, (blk, 0))
    g.connect(p1, (blk, 1))
    g.connect((blk, 0), s0)
    g.connect((blk, 1), s1)
    return g


def _chain(kind, make):
    m = PKG[kind]
    g = m["pkg"].Graph()
    pin = g.add_input(m["pkg"].Port(m["lib"].float32))
    g.connect(pin, *make(m))
    return g


def _fanout(kind):
    m = PKG[kind]
    g = m["pkg"].Graph()
    pin = g.add_input(m["pkg"].Port(m["lib"].float32))
    c = m["stream"].Copy(dtype=m["lib"].float32, name="copy")
    pout = g.add_output(m["pkg"].Port(m["lib"].float32))
    g.connect(pin, c)
    g.connect(c, m["gen"].VectorSink(name="s0"))
    g.connect(c, m["gen"].VectorSink(name="s1"))
    g.connect(c, pout)
    return g


# (graph builder, chunk, [(pad, tags)], number of input pads, sinks)
POLICY_CASES = {
    "keep_one_in_n": (lambda k: _chain(k, lambda m: [
        m["stream"].KeepOneInN(4, name="keep"),
        m["gen"].VectorSink(name="s0")]), 16, [(0, [(8, "mark", "a")])], 1),
    "interp": (lambda k: _chain(k, lambda m: [
        m["stream"].Repeat(4, dtype=m["lib"].float32, name="rep"),
        m["gen"].VectorSink(name="s0")]), 16, [(0, [(5, "m", None)])], 1),
    "one_to_one": (lambda k: _two_port(k, "one_to_one"), 16,
                   [(0, [(3, "a", None)]), (1, [(5, "b", None)])], 2),
    "all_to_all": (lambda k: _two_port(k, "all_to_all"), 16,
                   [(0, [(3, "a", None)]), (1, [(5, "b", None)])], 2),
    "dont": (lambda k: _two_port(k, "dont"), 16, [(0, [(3, "a", None)])], 2),
    "fanout": (_fanout, 16, [(0, [(7, "m", None), (40, "late", 2.5)])], 1),
}


@pytest.fixture(scope="module")
def grtpu_policy_runs():
    """grtpu's run of each propagation case, once (each is a JAX compile)."""
    out = {}
    for name, (build, chunk, tags, npads) in POLICY_CASES.items():
        ex = executor("j", build("j"), chunk)
        for pad, ts in tags:
            ex.add_tags(pad, [jtags.Tag(*t) for t in ts])
        run("j", ex, *[np.zeros(48, np.float32)] * npads)
        out[name] = ({s: sink_tags(ex, s) for s in ("s0", "s1")},
                     {p: tagset(v) for p, v in ex.pad_tags.items()},
                     {k: tagset(v) for k, v in ex._tags.items()})
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(POLICY_CASES))
def test_add_tags_propagation_matches_grtpu(grtpu_policy_runs, name, mode):
    """add_tags on the input pads, carried through decimation, interpolation,
    the three TPP policies and a fan-out to sinks and an output pad: the
    sink tags, pad tags and what stays on each edge equal grtpu's."""
    build, chunk, tags, npads = POLICY_CASES[name]
    ex = executor("t", build("t"), chunk)
    for pad, ts in tags:
        ex.add_tags(pad, [ttags.Tag(*t) for t in ts])
    run("t", ex, *[np.zeros(48, np.float32)] * npads, mode=mode)
    got = ({s: sink_tags(ex, s) for s in ("s0", "s1")},
           {p: tagset(v) for p, v in ex.pad_tags.items()},
           {k: tagset(v) for k, v in ex._tags.items()})
    assert got == grtpu_policy_runs[name]
    if name in ("keep_one_in_n", "interp"):
        want = 2 if name == "keep_one_in_n" else 20
        assert [t[0] for t in got[0]["s0"]] == [want]
    if name == "dont":
        assert got[0] == {"s0": [], "s1": []}
    assert ex.nitems == {b.name: 48 // chunk * ex.block_nin[b.uid]
                         for b in ex.order}


def _access_code_graph(kind, code, legacy=False, decoder=None):
    m = PKG[kind]
    lib = m["lib"]
    cat = m["corr"].CorrelateAccessCodeTag(code, key="sync", name="cat")
    if legacy:
        cat.device_tags = False        # the make_tags path
    g = m["pkg"].Graph()
    pin = g.add_input(m["pkg"].Port(lib.uint8))
    if decoder is None:
        g.connect(pin, cat, m["gen"].VectorSink(dtype=lib.uint8, name="s0"))
    else:
        dec = m["pb"].PacketDecoder("byte", payload_length=decoder,
                                    access_code=code, name="dec")
        g.connect(pin, cat, dec, m["gen"].VectorSink(dtype=lib.uint8, name="s0"))
    return g


def _planted_bits(seed, n, code, at):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    for a in at:
        bits[a:a + len(code)] = code
    return bits


AC_CODE = np.random.default_rng(0).integers(0, 2, 32).astype(np.uint8)
AC_CASES = {
    # the test_pmt_tags scenarios: planted twice, chunk 32
    "device_tags": (dict(), 32, _planted_bits(0, 128, AC_CODE, (20, 80))),
    "device_tags_long": (dict(), 32, _planted_bits(1, 256, AC_CODE, (20, 150))),
    "make_tags": (dict(legacy=True), 32,
                  _planted_bits(1, 256, AC_CODE, (20, 150))),
}


@pytest.fixture(scope="module")
def grtpu_access_code_runs():
    out = {}
    for name, (kw, chunk, bits) in AC_CASES.items():
        ex = executor("j", _access_code_graph("j", AC_CODE, **kw), chunk)
        run("j", ex, bits)
        out[name] = sink_tags(ex, "s0")
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(AC_CASES))
def test_correlate_access_code_tag_matches_grtpu(grtpu_access_code_runs,
                                                 name, mode):
    """CorrelateAccessCodeTag's tags (device records or make_tags), eager
    and under device_loop, equal grtpu's; the data passes through."""
    kw, chunk, bits = AC_CASES[name]
    g = _access_code_graph("t", AC_CODE, **kw)
    ex = executor("t", g, chunk)
    run("t", ex, bits, mode=mode)
    got = sink_tags(ex, "s0")
    assert got == grtpu_access_code_runs[name]
    planted = [a + 32 for a in ((20, 80) if name == "device_tags" else (20, 150))]
    assert set(planted) <= {t[0] for t in got}
    sink = next(b for b in ex.order if b.name == "s0")
    np.testing.assert_array_equal(sink.data(), bits)


def test_tag_topk_pads_with_minus_one():
    """_tag_topk: ascending hit offsets, at most max_tags_per_chunk of
    them, -1 after (grtpu's top_k on the recency score)."""
    blk = tcorr.CorrelateAccessCodeTag(AC_CODE)
    blk.max_tags_per_chunk = 4
    hits = torch.zeros(16, dtype=torch.bool)
    hits[[0, 3, 9]] = True
    offs, idx = blk._tag_topk(hits, 16)
    assert offs.tolist() == [0, 3, 9, -1] and idx.tolist() == [0, 3, 9, 0]
    hits[[11, 12, 15]] = True
    offs, _ = blk._tag_topk(hits, 16)
    assert offs.tolist() == [0, 3, 9, 11]
    jblk = jcorr.CorrelateAccessCodeTag(AC_CODE)
    jblk.max_tags_per_chunk = 4
    joffs, _ = jblk._tag_topk(jnp.asarray(hits.numpy()), 16)
    assert np.asarray(joffs).tolist() == offs.tolist()


def _vr_bits():
    """Two packets of a byte stream framed by PacketEncoder, with random
    bits around them: the tags ride through PacketDecoder (variable
    rate)."""
    from grtpu_torch.digital import packet as tpk

    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, 16).astype(np.uint8) for _ in range(2)]
    parts = [rng.integers(0, 2, 70).astype(np.uint8)]
    for p in payloads:
        parts += [tpk.make_packet(bytes(p)),
                  rng.integers(0, 2, 90).astype(np.uint8)]
    bits = np.concatenate(parts + [np.zeros(400, np.uint8)])
    return bits[: len(bits) // 64 * 64], payloads


@pytest.fixture(scope="module")
def grtpu_vr_run():
    from grtpu_torch.digital import packet as tpk

    bits, _ = _vr_bits()
    g = _access_code_graph("j", tpk.DEFAULT_ACCESS_CODE_BITS, decoder=16)
    ex = executor("j", g, 64)
    ex.add_tags(0, [jtags.Tag(5, "in", 1), jtags.Tag(300, "in", 2)])
    run("j", ex, bits)
    sink = next(b for b in ex.order if b.name == "s0")
    return sink_tags(ex, "s0"), np.asarray(sink.captured[0])


@pytest.mark.parametrize("mode", MODES)
def test_tags_cross_a_variable_rate_boundary_as_in_grtpu(grtpu_vr_run, mode):
    """Emitted and input tags upstream of PacketDecoder (variable rate)
    reach the sink with offsets scaled by its nominal rate, as grtpu scales
    them, eagerly and under device_loop; the payloads come out in order."""
    from grtpu_torch.digital import packet as tpk

    bits, payloads = _vr_bits()
    g = _access_code_graph("t", tpk.DEFAULT_ACCESS_CODE_BITS, decoder=16)
    ex = executor("t", g, 64)
    ex.add_tags(0, [ttags.Tag(5, "in", 1), ttags.Tag(300, "in", 2)])
    run("t", ex, bits, mode=mode)
    want_tags, want_data = grtpu_vr_run
    assert sink_tags(ex, "s0") == want_tags
    assert len([t for t in want_tags if t[1] == "sync"]) == 2
    sink = next(b for b in ex.order if b.name == "s0")
    np.testing.assert_array_equal(sink.data(), want_data)
    # whole emissions only: what is short of one stays in the FIFO
    sent = np.concatenate(payloads)
    assert len(sink.data()) >= len(payloads[0])
    np.testing.assert_array_equal(sink.data(), sent[: len(sink.data())])


# ------------------------------------------------------------------- TopBlock
@pytest.mark.parametrize("kind", ["t", "j"])
def test_top_block_run_lock_unlock_and_messages(kind):
    """TestTopBlock's scenarios in both packages: run like gr, lock/unlock
    keeps the delay line, a message handler runs after the run."""
    m = PKG[kind]
    lib, Port = m["lib"], m["pkg"].Port
    kw = {"device": "cpu"} if kind == "t" else {}
    rng = np.random.RandomState(66)

    tb = m["top"].TopBlock(chunk_size=32, **kw)
    pin = tb.add_input(Port(lib.float32))
    sink = m["gen"].VectorSink()
    tb.connect(pin, m["gen"].AddConst(1.0), sink)
    x = np.arange(64, dtype=np.float32)
    tb.run(x if kind == "t" else jnp.asarray(x))
    np.testing.assert_allclose(sink.data(), x + 1)

    tb = m["top"].TopBlock(chunk_size=16, **kw)
    pin = tb.add_input(Port(lib.float32))
    sink = m["gen"].VectorSink()
    tb.connect(pin, m["stream"].Delay(4), sink)
    x = rng.randn(32).astype(np.float32)
    tb.run(x[:16] if kind == "t" else jnp.asarray(x[:16]))
    tb.lock()
    tb.unlock()              # rebuild; the delay line's state survives
    tb.run(x[16:] if kind == "t" else jnp.asarray(x[16:]))
    np.testing.assert_allclose(sink.data()[:4], x[12:16])

    tb = m["top"].TopBlock(chunk_size=8, **kw)
    pin = tb.add_input(Port(lib.float32))
    sink = m["gen"].VectorSink()
    tb.connect(pin, sink)
    got = []
    tb.set_msg_handler(sink.name, lambda msg: got.append(msg.payload))
    tb.post_msg(sink.name, m["msg"].Message(payload=b"hello"))
    tb.run(np.zeros(8, np.float32) if kind == "t" else jnp.zeros(8))
    assert got == [b"hello"]
    tb.stop()
    tb.wait()


def test_testing_helpers_match_grtpu():
    """utils.testing: run_block and the tolerance helpers give grtpu's
    answers on the same block and input."""
    from grtpu.utils import testing as jtest
    from grtpu_torch.utils import testing as ttest

    x = np.random.RandomState(3).randn(64).astype(np.float32)
    got = ttest.run_block(tgen.AddConst(2.0), x, chunk_size=16, device="cpu")
    ref = jtest.run_block(jgen.AddConst(2.0), x, chunk_size=16)
    np.testing.assert_array_equal(got, ref)
    ttest.assert_float_tuples_almost_equal(got, ref, 6)
    ttest.assert_complex_tuples_almost_equal(got + 0j, ref + 0j, 6)
    with pytest.raises(AssertionError):
        ttest.assert_float_tuples_almost_equal(got, ref + 1e-3, 6)
    assert ttest.snr_db(ref, got + 1e-3) == pytest.approx(
        jtest.snr_db(ref, got + 1e-3), rel=1e-9)
