"""grtpu_torch's host I/O held against grtpu: files, WAV, UDP / TCP,
message bridges, XML-RPC control and the native ring.

Every case feeds both packages the same numpy input (local seeds): capture
and WAV files are byte-identical; the file sources' graphs equal grtpu's
with repeat on and off over a ragged tail; the tagged file sink cuts the
same bursts from the executor's tag store; the transports deliver what was
sent, as grtpu's do (tests/test_io_aux.py's cases); the native ring, its
converters and the ring -> ``StreamExecutor.stream()`` path give grtpu's
arrays.  The native cases skip only where ``available()`` is False (no C++
compiler), as grtpu's do.
"""

import os
import socket
import threading
import time
import xmlrpc.client
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import gengen as jgen  # noqa: E402
from grtpu.io import file as jfile, msgio as jmsgio, udp as judp  # noqa: E402
from grtpu.io import native as jnative, tcp as jtcp  # noqa: E402
from grtpu.io import xmlrpc_ctl as jctl  # noqa: E402
from grtpu.runtime import msg as jmsg, tags as jtags  # noqa: E402
from grtpu_torch.blocks import gengen as tgen  # noqa: E402
from grtpu_torch.io import file as tfile, msgio as tmsgio, udp as tudp  # noqa: E402
from grtpu_torch.io import native as tnative, tcp as ttcp  # noqa: E402
from grtpu_torch.io import xmlrpc_ctl as tctl  # noqa: E402
from grtpu_torch.runtime import msg as tmsg, tags as ttags  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKG = {"j": dict(pkg=grtpu, lib=jnp, gen=jgen, file=jfile, tags=jtags),
       "t": dict(pkg=grtpu_torch, lib=torch, gen=tgen, file=tfile,
                 tags=ttags)}


def executor(kind, g, chunk):
    if kind == "j":
        return grtpu.StreamExecutor(g, chunk_size=chunk, donate=False)
    return grtpu_torch.StreamExecutor(g, chunk_size=chunk, device="cpu")


def cnoise(n, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n) + 1j * r.randn(n)).astype(np.complex64)


def free_port(kind=socket.SOCK_DGRAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def need_native():
    if not (tnative.available() and jnative.available()):
        pytest.skip("no native compiler")


# ------------------------------------------------------------------ files
@pytest.mark.parametrize("dtype", [np.complex64, np.float32, np.int16,
                                   np.uint8])
def test_capture_files_byte_identical(tmp_path, dtype):
    r = np.random.RandomState(1)
    x = (r.randn(777) * 100).astype(dtype)
    for kind, mod in (("j", jfile), ("t", tfile)):
        mod.save_capture(str(tmp_path / f"{kind}.bin"), x)
        mod.save_capture(str(tmp_path / f"{kind}.bin"), x[:100], append=True)
    # the port also writes a tensor
    tfile.save_capture(str(tmp_path / "tt.bin"), torch.from_numpy(x))
    tfile.save_capture(str(tmp_path / "tt.bin"), torch.from_numpy(x[:100]),
                       append=True)
    want = (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").read_bytes() == want
    assert (tmp_path / "tt.bin").read_bytes() == want
    for kw in ({}, dict(offset_items=100, nitems=50)):
        a = jfile.load_capture(str(tmp_path / "j.bin"), dtype, **kw)
        b = tfile.load_capture(str(tmp_path / "j.bin"), dtype, **kw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nch", [1, 2])
def test_wav_files_byte_identical(tmp_path, nch):
    r = np.random.RandomState(2)
    x = np.clip(0.6 * r.randn(4001, nch), -1.2, 1.2).astype(np.float32)
    if nch == 1:
        x = x[:, 0]
    jfile.save_wav(str(tmp_path / "j.wav"), 8000, x)
    tfile.save_wav(str(tmp_path / "t.wav"), 8000, x)
    tfile.save_wav(str(tmp_path / "tt.wav"), 8000, torch.from_numpy(x))
    want = (tmp_path / "j.wav").read_bytes()
    assert (tmp_path / "t.wav").read_bytes() == want
    assert (tmp_path / "tt.wav").read_bytes() == want
    ra, a = jfile.load_wav(str(tmp_path / "j.wav"))
    rb, b = tfile.load_wav(str(tmp_path / "j.wav"))
    assert ra == rb == 8000
    np.testing.assert_array_equal(a, b)


def file_graph(kind, path, repeat, chunk, steps, **kw):
    m = PKG[kind]
    g = m["pkg"].Graph()
    src = m["file"].FileSource(path, m["lib"].complex64, repeat=repeat)
    sink = m["gen"].VectorSink(m["lib"].complex64)
    g.connect(src, sink)
    executor(kind, g, chunk).run(steps=steps, **kw)
    return np.asarray(sink.data())


@pytest.mark.parametrize("mode", ["eager", "device_loop"])
@pytest.mark.parametrize("repeat", [False, True], ids=["once", "repeat"])
def test_file_source_graph_equals_grtpu(tmp_path, repeat, mode):
    """1000 items read at chunk 256 for 5 steps: a ragged tail (zeros when
    played once, the file again when repeated) past the file's end; the
    port eagerly and under run(device_loop=True)."""
    path = str(tmp_path / "in.cfile")
    x = cnoise(1000, 3)
    jfile.save_capture(path, x)
    a = file_graph("j", path, repeat, 256, 5)
    b = file_graph("t", path, repeat, 256, 5,
                   device_loop=mode == "device_loop")
    assert b.dtype == np.complex64 and b.shape == (1280,)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b[:1000], x)
    np.testing.assert_array_equal(b[1000:], x[:280] if repeat else 0)


def test_file_sink_flush_equals_grtpu(tmp_path):
    x = cnoise(300, 4)
    for kind in ("j", "t"):
        m = PKG[kind]
        g = m["pkg"].Graph()
        pin = g.add_input(m["pkg"].Port(m["lib"].complex64))
        snk = m["file"].FileSink(str(tmp_path / f"{kind}.cfile"),
                                 m["lib"].complex64)
        g.connect(pin, snk)
        executor(kind, g, 64).run(x if kind == "t" else jnp.asarray(x))
        snk.flush()
    assert ((tmp_path / "t.cfile").read_bytes()
            == (tmp_path / "j.cfile").read_bytes())
    np.testing.assert_array_equal(
        tfile.load_capture(str(tmp_path / "t.cfile")), x)


@pytest.mark.parametrize("repeat", [False, True], ids=["once", "repeat"])
def test_wav_source_and_sink_equal_grtpu(tmp_path, repeat):
    """A stereo WAV of 700 frames through WavFileSource at chunk 256 for 4
    steps into WavFileSink: both channels equal grtpu's, and the written
    WAV is byte-identical."""
    r = np.random.RandomState(5)
    jfile.save_wav(str(tmp_path / "in.wav"), 16000,
                   (0.5 * r.randn(700, 2)).astype(np.float32))
    outs = {}
    for kind in ("j", "t"):
        m = PKG[kind]
        g = m["pkg"].Graph()
        src = m["file"].WavFileSource(str(tmp_path / "in.wav"), repeat=repeat)
        sinks = [m["gen"].VectorSink(m["lib"].float32) for _ in range(2)]
        wav = m["file"].WavFileSink(str(tmp_path / f"{kind}.wav"), 16000, 2)
        for c in range(2):
            g.connect((src, c), sinks[c])
            g.connect((src, c), (wav, c))
        executor(kind, g, 256).run(steps=4)
        wav.flush()
        outs[kind] = [np.asarray(s.data()) for s in sinks]
    for a, b in zip(outs["j"], outs["t"]):
        assert b.shape == (1024,)
        np.testing.assert_array_equal(a, b)
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())


def test_tagged_file_sink_bursts_equal_grtpu(tmp_path):
    """Burst tags on the input pad reach TaggedFileSink through the
    executor's tag store (``sink_tags``); flush cuts the same bursts and
    writes byte-identical files (a burst left open at the end is dropped,
    as in grtpu)."""
    x = cnoise(1000, 6)
    offsets = [(40, True), (130, False), (300, True), (700, False),
               (900, True)]
    bursts = {}
    for kind in ("j", "t"):
        m = PKG[kind]
        g = m["pkg"].Graph()
        pin = g.add_input(m["pkg"].Port(m["lib"].complex64))
        snk = m["file"].TaggedFileSink(str(tmp_path / kind),
                                       m["lib"].complex64)
        g.connect(pin, snk)
        ex = executor(kind, g, 128)
        ex.add_tags(0, [m["tags"].Tag(o, "burst", v) for o, v in offsets])
        ex.run(x if kind == "t" else jnp.asarray(x))
        bursts[kind] = snk.flush(ex.sink_tags[snk.name])
    assert bursts["t"] == bursts["j"] == [(40, 130), (300, 700)]
    for i in range(2):
        name = f".{i:04d}.dat"
        assert ((tmp_path / ("t" + name)).read_bytes()
                == (tmp_path / ("j" + name)).read_bytes())
    assert not (tmp_path / "t.0002.dat").exists()


# ------------------------------------------------------------- transports
@pytest.mark.parametrize("mod", [judp, tudp], ids=["grtpu", "port"])
def test_udp_loopback(mod):
    """gr_udp_source / gr_udp_sink loopback (the reference's network
    demos): the same items arrive through both packages."""
    x = cnoise(2000, 7)
    src = mod.UdpSource("127.0.0.1", 0, np.complex64, timeout=2.0)
    port = src.sock.getsockname()[1]
    snk = mod.UdpSink("127.0.0.1", port, np.complex64)
    t = threading.Thread(target=lambda: snk.write_items(x))
    t.start()
    got = src.read_items(2000)
    t.join(timeout=10.0)
    assert not t.is_alive()
    snk.close()
    assert src.read_items(1) is None  # the zero-length datagram ends it
    src.close()
    np.testing.assert_array_equal(got, x)


def tcp_pair(mod, port, dtype, n, pieces):
    results = {}

    def serve():
        src = mod.TcpSource("127.0.0.1", port, dtype, server=True,
                            timeout=5.0)
        results["got"] = src.read_items(n)
        src.close()

    t = threading.Thread(target=serve)
    t.start()
    snk = None
    t0 = time.monotonic()
    while snk is None and time.monotonic() - t0 < 5.0:
        try:
            snk = mod.TcpSink("127.0.0.1", port, dtype, server=False)
        except OSError:
            time.sleep(0.05)
    for p in pieces:
        snk.write_items(p)
    snk.close()
    t.join(timeout=10.0)
    assert not t.is_alive()
    return results["got"]


@pytest.mark.parametrize("mod", [jtcp, ttcp], ids=["grtpu", "port"])
def test_tcp_loopback_and_eof(mod):
    """Server source / client sink with exact item reassembly across uneven
    writes; a peer that closes early is EOF (None)."""
    x = cnoise(3000, 8)
    got = tcp_pair(mod, free_port(socket.SOCK_STREAM), np.complex64, 3000,
                   [x[:700], x[700:1701], x[1701:]])
    np.testing.assert_array_equal(got, x)
    assert tcp_pair(mod, free_port(socket.SOCK_STREAM), np.float32, 100,
                    [np.arange(10, dtype=np.float32)]) is None


class FakeTopBlock:
    def __init__(self):
        self.freq = 0.0
        self.started = False

    def set_freq(self, f):
        self.freq = f

    def get_freq(self):
        return self.freq

    def start(self):
        self.started = True

    def _private(self):  # must not be exported
        raise AssertionError


@pytest.mark.parametrize("mod", [jctl, tctl], ids=["grtpu", "port"])
def test_xmlrpc_remote_variable_control(mod):
    """xmlrpc_server / xmlrpc_client: remote set_* reach the instance; a
    private method is not exported."""
    tb = FakeTopBlock()
    srv = mod.XmlrpcServer(tb, "127.0.0.1", 0)
    try:
        cli = mod.XmlrpcClient("127.0.0.1", srv.port)
        cli.callback("set_freq", 5000.0)
        assert tb.freq == 5000.0
        assert cli.get_freq() == 5000.0
        cli.start()
        assert tb.started
        with pytest.raises(xmlrpc.client.Fault):
            cli.callback("_private")
    finally:
        srv.stop()


def test_message_bridges_equal_grtpu():
    """MessageSource drains the queue into fixed chunks (zero-padded when
    dry); MessageStreamSink frames a stream into messages."""
    got = {}
    for kind, io, msg in (("j", jmsgio, jmsg), ("t", tmsgio, tmsg)):
        q = msg.MsgQueue()
        ms = io.MessageSource(np.uint8, q)
        q.insert_tail(msg.Message(payload=bytes(range(10))))
        q.insert_tail(msg.Message(payload=bytes(range(10, 20))))
        a, b = ms.fill(15), ms.fill(10)
        q.insert_tail(msg.Message(payload=b"", kind=1))
        ms.fill(4)
        sink = io.MessageStreamSink(8, np.uint8)
        sink.push(np.arange(20, dtype=np.uint8))
        framed = []
        while not sink.msgq.empty_p():
            framed.append(sink.msgq.delete_head_nowait().to_string())
        got[kind] = (a.tobytes(), b.tobytes(), ms.eof, framed,
                     sink._buf.tobytes())
    assert got["t"] == got["j"]
    assert got["t"][0] == bytes(range(15)) and got["t"][2] is True
    assert len(got["t"][3]) == 2


# ------------------------------------------------------------- native ring
def test_native_build_is_keyed_and_outside_the_package(tmp_path):
    """The library is built under build/grtpu_torch/, named by a hash of the
    sources and flags: an edited source or flag gives another path, and
    building writes nothing under grtpu_torch/."""
    from grtpu_torch.ops import _build

    srcs = []
    for s in tnative.SOURCES:
        srcs.append(tmp_path / s.name)
        srcs[-1].write_bytes(s.read_bytes())
    flags = (*tnative.FLAGS, *tnative.LIBS)
    base = _build.hashed_path("libgrtpu_ringbuf", srcs, flags)
    assert base == tnative.library_path()
    assert base.parent == REPO / "build" / "grtpu_torch"
    assert _build.hashed_path("libgrtpu_ringbuf", srcs,
                              ("-O2",) + flags[1:]) != base
    srcs[1].write_bytes(srcs[1].read_bytes() + b"\n// edited\n")
    assert _build.hashed_path("libgrtpu_ringbuf", srcs, flags) != base
    pkg = REPO / "grtpu_torch"
    before = {p for p in pkg.rglob("*") if "__pycache__" not in p.parts}
    if tnative.available():
        assert tnative.library_path().exists()
    after = {p for p in pkg.rglob("*") if "__pycache__" not in p.parts}
    assert after == before
    assert not [p for p in after if p.suffix == ".so"]


def test_ring_roundtrip_and_wraparound():
    need_native()
    rb = tnative.RingBuffer(1 << 16)
    data = bytes(np.random.RandomState(9).randint(0, 256, 100000)
                 .astype(np.uint8))
    written, out = 0, bytearray()
    while written < len(data) or rb.readable:
        if written < len(data):
            written += rb.write(data[written:written + 8192])
        out.extend(rb.read(4096))
    assert bytes(out) == data
    cap = rb.capacity
    rb.write(b"x" * (cap - 100))
    rb.read(cap - 100)
    payload = bytes(range(200))
    rb.write(payload)
    assert rb.read(200) == payload  # a read across the physical end
    rb.close()


def pump_all(native, path, dtype, n_items):
    rb = native.RingBuffer(1 << 20)
    pump = native.FilePump(rb, path)
    got = []
    deadline = time.time() + 10
    while time.time() < deadline:
        arr = rb.read_items(n_items, dtype)
        if arr is not None:
            got.append(arr)
        elif rb.eof and rb.readable < n_items * np.dtype(dtype).itemsize:
            break
        else:
            time.sleep(0.001)
    pump.stop()
    rb.close()
    return np.concatenate(got)


def test_file_pump_equals_grtpu(tmp_path):
    need_native()
    path = str(tmp_path / "cap.bin")
    x = cnoise(65536, 10)
    x.tofile(path)
    a = pump_all(jnative, path, np.complex64, 8192)
    b = pump_all(tnative, path, np.complex64, 8192)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, x)


WIRES = [
    ("raw", np.float32, {}, 4096),
    ("i16", np.int16, dict(scale=1.0 / 32768), 2500),
    ("u8", np.uint8, dict(scale=1 / 128.0, offset=-127.0), 1000),
    ("sc16", np.int16, dict(scale=1.0), 4096),
]


@pytest.mark.parametrize("wire,dtype,kw,chunk", WIRES,
                         ids=[w[0] for w in WIRES])
def test_native_file_source_equals_grtpu(tmp_path, wire, dtype, kw, chunk):
    """NativeFileSource in every wire format: the chunks (the last one
    zero-padded) equal grtpu's."""
    need_native()
    r = np.random.RandomState(11)
    if dtype == np.float32:
        x = r.randn(40000).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        x = r.randint(info.min, int(info.max) + 1, 10001).astype(dtype)
    path = str(tmp_path / "cap")
    x.tofile(path)
    got = {}
    for kind, native in (("j", jnative), ("t", tnative)):
        src = native.NativeFileSource(path, np.float32, wire=wire, **kw)
        got[kind] = list(src.chunks(chunk))
        src.close()
    assert len(got["t"]) == len(got["j"]) > 1
    for a, b in zip(got["j"], got["t"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_converters_and_write_pump_equal_grtpu(tmp_path):
    need_native()
    x = np.array([0.0, 0.5, -0.5, 1.5, -1.5, 1 / 32767.0, 2.5e-5], np.float32)
    a = jnative.f32_to_i16(x, scale=32767.0)
    b = tnative.f32_to_i16(x, scale=32767.0)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b[:6], [0, 16384, -16384, 32767, -32768, 1])
    path = str(tmp_path / "out.bin")
    rb = tnative.RingBuffer(1 << 16)
    wp = tnative.WritePump(rb, path)
    y = np.random.RandomState(12).randn(100000).astype(np.float32)
    wp.write(y)
    wp.close()
    np.testing.assert_array_equal(np.fromfile(path, np.float32), y)


def test_udp_pump_and_native_udp_source():
    """Native sender -> native receiver pump (EOF on the zero-length
    datagram), and native_udp_source's chunks from a UdpSink."""
    need_native()
    rb = tnative.RingBuffer(1 << 20)
    port = free_port()
    pump = tnative.UdpPump(rb, "127.0.0.1", port)
    snd = tnative.UdpSender("127.0.0.1", port)
    x = np.random.RandomState(13).randn(30000).astype(np.float32)
    snd.send(x)
    snd.close()
    deadline = time.time() + 10
    while time.time() < deadline and rb.readable < x.nbytes:
        time.sleep(0.002)
    got = rb.read_items(30000, np.float32)
    pump.stop()
    np.testing.assert_array_equal(got, x)
    assert rb.eof
    rb.close()

    port = free_port()
    src = tudp.native_udp_source("127.0.0.1", port, np.complex64)
    snk = tudp.UdpSink("127.0.0.1", port, np.complex64)
    z = cnoise(8192, 14)
    snk.write_items(z)
    snk.close()
    got = np.concatenate(list(src.chunks(2048)))
    assert src.stats()[1] == z.nbytes
    src.close()
    np.testing.assert_array_equal(got, z)


def test_ring_feeds_stream_as_grtpu(tmp_path):
    """Capture file -> native ring (pump thread) -> ``stream()`` over
    MultiplyConst: the port's outputs equal grtpu's, chunk for chunk."""
    need_native()
    path = str(tmp_path / "cap.f32")
    x = np.random.RandomState(15).randn(32768).astype(np.float32)
    x.tofile(path)
    outs = {}
    for kind, native in (("j", jnative), ("t", tnative)):
        m = PKG[kind]
        g = m["pkg"].Graph()
        pin = g.add_input(m["pkg"].Port(m["lib"].float32))
        pout = g.add_output(m["pkg"].Port(m["lib"].float32))
        g.connect(pin, m["gen"].MultiplyConst(2.0), pout)
        src = native.NativeFileSource(path, np.float32)
        outs[kind] = [np.asarray(o) for o in
                      executor(kind, g, 4096).stream(src.chunks(4096))]
        src.close()
    assert len(outs["t"]) == len(outs["j"]) == 8
    for a, b in zip(outs["j"], outs["t"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(outs["t"]), 2 * x)
