"""grtpu_torch's packet layer held against grtpu on the CPU.

CRC32, whitening and framing (``digital.packet``, the port's own copy: byte
for byte equal), the access-code correlators, the simple framer and
correlator, the framer and packet sinks delivering to a MsgQueue, the
streaming PacketEncoder / PacketDecoder, the packet-mode modem framework
(ModPkts / DemodPkts) and the carrier-sense MAC.  The scenarios are those
of tests/test_coding.py (TestCrc32, TestPacket, TestCorrelator,
TestFramerPacketSinks), tests/test_vr_graph.py::TestPacketBlocks,
tests/test_pager_misc.py::TestSimpleFramerCorrelator and
tests/test_apps.py (TestPktFramework, TestTunnelMac), on the same numpy
inputs (local seeds).  Bytes, bits, flags and decisions are compared
exactly; the PN correlator's complex sums to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import gengen as jgen  # noqa: E402
from grtpu.digital import correlate as jcorr, packet as jpk  # noqa: E402
from grtpu.digital import packet_blocks as jpb  # noqa: E402
from grtpu_torch.blocks import gengen as tgen  # noqa: E402
from grtpu_torch.digital import correlate as tcorr, packet as tpk  # noqa: E402
from grtpu_torch.digital import packet_blocks as tpb  # noqa: E402

PKG = {"j": (grtpu, jnp, jgen, jcorr, jpb), "t": (grtpu_torch, torch, tgen,
                                                  tcorr, tpb)}


def run_graph(kind, blocks, x, chunk, in_dtype, out_dtype=None,
              device_loop=False, vr_emit=None):
    """pad -> blocks -> (output pad | the last block as a sink); with
    ``vr_emit``, the last block is variable-rate and emits that many items
    at a time."""
    pkg, lib = PKG[kind][:2]
    g = pkg.Graph()
    pin = g.add_input(pkg.Port(getattr(lib, in_dtype)))
    if out_dtype is None:
        g.connect(pin, *blocks)
    else:
        g.connect(pin, *blocks, g.add_output(pkg.Port(getattr(lib, out_dtype))))
    kw = {} if vr_emit is None else {"vr_chunks": {blocks[-1]: vr_emit}}
    if kind == "j":
        y = pkg.StreamExecutor(g, chunk_size=chunk, **kw).run(jnp.asarray(x))
        return None if out_dtype is None else np.asarray(y)
    y = pkg.StreamExecutor(g, chunk_size=chunk, device="cpu", **kw).run(
        x, device_loop=device_loop)
    return None if out_dtype is None else y.numpy()


# ---------------------------------------------------------------- packet.py
def test_packet_module_is_an_identical_copy():
    """CRC32 (the BZIP2 check value), whitening, headers, make/unmake and
    the access-code search give grtpu's bytes and bits."""
    rng = np.random.RandomState(77)
    assert tpk.crc32(b"123456789") == jpk.crc32(b"123456789") == 0xFC891918
    np.testing.assert_array_equal(tpk._TABLE, jpk._TABLE)
    np.testing.assert_array_equal(tpk._WHITENER, jpk._WHITENER)
    for n in (0, 1, 11, 100, 1500):
        p = bytes(rng.randint(0, 256, n).astype(np.uint8))
        assert tpk.gen_and_append_crc32(p) == jpk.gen_and_append_crc32(p)
        assert tpk.check_crc32(tpk.gen_and_append_crc32(p)) == (True, p)
        for off in (0, 3, 15):
            assert tpk.whiten(p, off) == jpk.whiten(p, off)
            assert tpk.dewhiten(tpk.whiten(p, off), off) == p
            np.testing.assert_array_equal(
                tpk.make_packet(p, whitener_offset=off),
                jpk.make_packet(p, whitener_offset=off))
    framed = bytearray(tpk.gen_and_append_crc32(b"hello world"))
    framed[3] ^= 0x40
    assert tpk.check_crc32(bytes(framed)) == jpk.check_crc32(bytes(framed))
    assert not tpk.check_crc32(bytes(framed))[0]
    assert tpk.make_header(1234, 7) == jpk.make_header(1234, 7)
    assert tpk.parse_header(tpk.make_header(1234, 7)) == (1234, 7)
    assert tpk.parse_header(b"\x00\x01\x00\x02") is None


def test_make_unmake_and_access_code_with_errors():
    """TestPacket's round trip and the access-code search within a bit
    error threshold."""
    rng = np.random.RandomState(77)
    payload = bytes(rng.randint(0, 256, 64).astype(np.uint8))
    bits = tpk.make_packet(payload)
    idx = tpk.find_access_code(bits)
    assert idx == jpk.find_access_code(bits) and idx is not None
    plen, offset = tpk.parse_header(tpk.bits_to_bytes(bits[idx: idx + 32]))
    assert plen == len(payload) + 4
    ok, msg = tpk.unmake_packet(bits[idx + 32: idx + 32 + plen * 8], offset)
    assert ok and msg == payload
    bits[40] ^= 1                   # inside the access code
    for t in (0, 1, 2):
        assert tpk.find_access_code(bits, threshold=t) == \
            jpk.find_access_code(bits, threshold=t)
    assert tpk.find_access_code(bits, threshold=2) is not None


# ----------------------------------------------------------- correlate.py
@pytest.mark.parametrize("threshold", [0, 2])
def test_access_code_detect_matches_grtpu(threshold):
    """Sliding mismatch counts over +-1 sums are exact integers in float32:
    the flags are grtpu's, bit for bit."""
    rng = np.random.RandomState(5)
    code = rng.randint(0, 2, 64).astype(np.uint8)
    stream = rng.randint(0, 2, 2000).astype(np.uint8)
    for a in (50, 700, 1500):
        stream[a:a + 64] = code
        stream[a + 10] ^= 1
    got = tcorr.access_code_detect(torch.from_numpy(stream), code, threshold)
    ref = jcorr.access_code_detect(jnp.asarray(stream), code, threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum() >= (3 if threshold else 0)


@pytest.mark.parametrize("chunk", [36, 72])
def test_correlate_access_code_block_matches_grtpu(chunk):
    """TestCorrelator: the flag rides on the first payload bit, the data
    passes through; the port's stream equals grtpu's at two chunk sizes."""
    rng = np.random.RandomState(77)
    code = np.array([1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 0], np.uint8)
    stream = np.concatenate([rng.randint(0, 2, 20), code,
                             rng.randint(0, 2, 112)]).astype(np.uint8)
    outs = {k: run_graph(k, [PKG[k][3].CorrelateAccessCode(code, 0)], stream,
                         chunk, "uint8", "uint8") for k in PKG}
    np.testing.assert_array_equal(outs["t"], outs["j"])
    assert 32 in np.flatnonzero(outs["t"] & 2)
    np.testing.assert_array_equal(outs["t"] & 1, stream)


def test_pn_correlator_matches_grtpu():
    rng = np.random.RandomState(9)
    blk = {k: PKG[k][3].PnCorrelator(5) for k in PKG}
    np.testing.assert_array_equal(blk["t"].pn, blk["j"].pn)
    x = np.tile(blk["t"].pn, 4).astype(np.complex64) * (0.5 - 0.25j)
    x = (x + 0.1 * (rng.randn(len(x)) + 1j * rng.randn(len(x)))).astype(
        np.complex64)
    outs = {k: run_graph(k, [blk[k]], x, len(x), "complex64", "complex64")
            for k in PKG}
    np.testing.assert_allclose(outs["t"], outs["j"], atol=1e-6)
    np.testing.assert_allclose(outs["t"], 0.5 - 0.25j, atol=0.1)


def _packet_bits(payload, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randint(0, 2, 37), tpk.make_packet(payload),
                           rng.randint(0, 2, 23)]).astype(np.uint8)


@pytest.mark.parametrize("sink", ["framer", "packet"])
def test_framer_and_packet_sinks_deliver_messages(sink):
    """FramerSink (behind CorrelateAccessCode) and PacketSink (hunting the
    code itself) post one Message per frame to their MsgQueue: the raw
    whitened payload with the typed header's defaults, as grtpu posts it;
    unmake_packet then recovers the plaintext."""
    payload = b"hello framer sink" if sink == "framer" else b"via packet_sink"
    stream = _packet_bits(payload, 3)
    msgs = {}
    for k in PKG:
        corr = PKG[k][3]
        if sink == "framer":
            s = corr.FramerSink()
            blocks = [corr.CorrelateAccessCode(tpk.DEFAULT_ACCESS_CODE_BITS, 0), s]
        else:
            s = corr.PacketSink(threshold=0)
            blocks = [s]
        run_graph(k, blocks, stream, len(stream), "uint8")
        m = s.msgq.delete_head_nowait()
        assert m is not None and s.msgq.delete_head_nowait() is None
        msgs[k] = (m.to_string(), m.kind, m.arg1, m.arg2)
    assert msgs["t"] == msgs["j"]
    ok, got = tpk.unmake_packet(np.unpackbits(np.frombuffer(msgs["t"][0],
                                                            np.uint8)))
    assert ok and got == payload


@pytest.mark.parametrize("noise,seed,npkts", [(0.0, 0, 4), (0.25, 3, 4)])
def test_simple_framer_correlator_roundtrip(noise, seed, npkts):
    """TestSimpleFramerCorrelator: SimpleFramer -> NRZ at 8 samples a bit
    -> simple_correlator_burst gives grtpu's payloads, sequence numbers and
    valid flags; every packet comes back."""
    payload = 16
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (npkts, payload)).astype(np.uint8)
    outs = {}
    for k in PKG:
        fr = PKG[k][3].SimpleFramer(payload)
        _, framed = fr.apply(fr.init_state(), PKG[k][1].asarray(
            data.reshape(-1)) if k == "j" else torch.from_numpy(data.reshape(-1)))
        outs[k] = np.asarray(framed)
    np.testing.assert_array_equal(outs["t"], outs["j"])
    wave = np.repeat(np.unpackbits(outs["t"]).astype(np.float32) * 2 - 1, 8)
    wave = np.concatenate([np.zeros(600, np.float32), wave,
                           np.zeros(600, np.float32)])
    wave += noise * rng.standard_normal(len(wave)).astype(np.float32)
    got = tcorr.simple_correlator_burst(torch.from_numpy(wave), payload,
                                        max_packets=npkts + 2)
    ref = jcorr.simple_correlator_burst(jnp.asarray(wave), payload,
                                        max_packets=npkts + 2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ok = got[2].numpy()
    assert (got[0].numpy()[ok] == data).all()
    assert got[1].numpy()[ok].tolist() == list(range(npkts))


def test_simple_correlator_block_mask_and_compact():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (2, 8)).astype(np.uint8)
    fr = tcorr.SimpleFramer(8)
    _, framed = fr.apply(fr.init_state(), torch.from_numpy(data.reshape(-1)))
    wave = np.repeat(np.unpackbits(framed.numpy()).astype(np.float32) * 2 - 1, 8)
    wave = np.concatenate([np.zeros(600, np.float32), wave,
                           np.zeros(200, np.float32)])
    blk = tcorr.SimpleCorrelator(8, max_packets=4)
    _, (y, n) = blk.apply(blk.init_state(), torch.from_numpy(wave))
    jblk = jcorr.SimpleCorrelator(8, max_packets=4)
    _, (jy, jn) = jblk.apply(jblk.init_state(), jnp.asarray(wave))
    assert int(n) == int(jn) == 16
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert (y.numpy()[:16].reshape(2, 8) == data).all()


# ------------------------------------------------------- packet_blocks.py
ITEMS = {"float": np.float32, "complex": np.complex64, "byte": np.uint8,
         "short": np.int16, "int": np.int32}


def _items(kind, n, rng):
    if kind == "complex":
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
    if kind == "float":
        return rng.standard_normal(n).astype(np.float32)
    return rng.integers(-100 if kind != "byte" else 0, 100, n).astype(ITEMS[kind])


@pytest.mark.parametrize("kind", list(ITEMS))
def test_item_bytes_both_ways(kind):
    """Tensor.view(torch.uint8) on a contiguous tensor: the raw
    little-endian item bytes (a complex64 item is 8 bytes, real first), as
    grtpu's bitcast gives them and as numpy lays them out; and back."""
    x = _items(kind, 24, np.random.default_rng(2))
    by = tpb._items_to_bytes(torch.from_numpy(x))
    np.testing.assert_array_equal(by.numpy(), np.frombuffer(x.tobytes(), np.uint8))
    np.testing.assert_array_equal(by.numpy(),
                                  np.asarray(jpb._items_to_bytes(jnp.asarray(x))))
    back = tpb._bytes_to_items(by, tpb._DT[kind])
    np.testing.assert_array_equal(back.numpy(), x)
    rows = tpb._bytes_to_items(by.reshape(3, -1), tpb._DT[kind])
    np.testing.assert_array_equal(rows.numpy().reshape(-1), x)


@pytest.mark.parametrize("kind", ["float", "complex", "byte"])
def test_packet_encoder_is_byte_identical(kind):
    """PacketEncoder: the framed bytes equal grtpu's, and equal
    packet.make_packet of each payload (CRC32 by the byte scan)."""
    L = 64
    x = _items(kind, L // np.dtype(ITEMS[kind]).itemsize * 3,
               np.random.default_rng(1))
    outs = {k: run_graph(k, [PKG[k][4].PacketEncoder(kind, L)], x, len(x),
                         {"float": "float32", "complex": "complex64",
                          "byte": "uint8"}[kind], "uint8") for k in PKG}
    np.testing.assert_array_equal(outs["t"], outs["j"])
    raw = x.tobytes()
    want = np.concatenate([np.packbits(tpk.make_packet(raw[i:i + L]))
                           for i in range(0, len(raw), L)])
    np.testing.assert_array_equal(outs["t"], want)


@pytest.mark.parametrize("device_loop", [False, True])
def test_packet_stream_roundtrip(device_loop):
    """TestPacketBlocks: PacketEncoder -> bits -> PacketDecoder recovers the
    float stream exactly and equals grtpu's output."""
    x = np.random.default_rng(0).standard_normal(2048).astype(np.float32)
    outs = {}
    for k in PKG:
        gen, pb = PKG[k][2], PKG[k][4]
        outs[k] = run_graph(k, [pb.PacketEncoder("float", payload_length=64),
                                gen.PackedToUnpacked(1),
                                pb.PacketDecoder("float", payload_length=64)],
                            x, 256, "float32", "float32",
                            device_loop=device_loop and k == "t")
    np.testing.assert_array_equal(outs["t"], outs["j"])
    assert len(outs["t"]) > 1500
    np.testing.assert_array_equal(outs["t"], x[: len(outs["t"])])


def test_corrupted_packet_dropped():
    """One flipped payload bit: that packet fails its CRC and is dropped,
    the rest come back in order, as in grtpu."""
    x = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    enc = tpb.PacketEncoder("float", payload_length=64)
    _, by = enc.apply((), torch.from_numpy(x))
    bits = np.unpackbits(by.numpy())
    pkt_bits = len(bits) // (512 // 16)
    bits[pkt_bits * 1 + 140] ^= 1
    outs = {k: run_graph(k, [PKG[k][4].PacketDecoder("float", payload_length=64)],
                         bits, len(bits), "uint8", "float32", vr_emit=16)
            for k in PKG}
    np.testing.assert_array_equal(outs["t"], outs["j"])
    per = 16
    y = outs["t"]
    assert len(y) == len(x) - per
    np.testing.assert_array_equal(y[:per], x[:per])
    np.testing.assert_array_equal(y[per:], x[2 * per:])


def test_packet_decoder_hit_near_the_chunk_end():
    """A packet whose access code ends within one packet of a chunk's end
    is deferred (its clamped window is not taken) and comes out of the
    next chunk, as in grtpu."""
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 16).astype(np.uint8)
    pkt = tpk.make_packet(bytes(payload))
    for lead in (200, 230, 250):
        bits = np.concatenate([rng.integers(0, 2, lead).astype(np.uint8), pkt,
                               np.zeros(900, np.uint8)])[:1024]
        outs = {k: run_graph(k, [PKG[k][4].PacketDecoder("byte", 16)], bits,
                             256, "uint8", "uint8", vr_emit=16) for k in PKG}
        np.testing.assert_array_equal(outs["t"], outs["j"])
        np.testing.assert_array_equal(outs["t"], payload)


# ---------------------------------------------------------- pkt.py, tunnel
def test_mod_demod_pkts_loop():
    """TestPktFramework: ModPkts -> AWGN -> DemodPkts delivers every payload,
    CRC-good, through the watcher thread (stopped and joined)."""
    import time

    from grtpu_torch.digital.modems import GmskModem, awgn
    from grtpu_torch.digital.pkt import DemodPkts, ModPkts

    modem = GmskModem(samples_per_symbol=4, device="cpu")
    tx = ModPkts(modem)
    received = []
    rx = DemodPkts(modem, lambda ok, payload: received.append((ok, payload)))
    payloads = [b"packet one", b"packet two!", b"third"]
    try:
        for p in payloads:
            tx.send_pkt(p)
        tx.send_pkt(eof=True)
        for burst in tx.drain():
            rx.process_samples(awgn(burst, 15.0, seed=1))
        deadline = time.time() + 10
        while len(received) < len(payloads) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        rx.stop(timeout=10)
    assert not rx._watcher.thread.is_alive()
    assert received == [(True, p) for p in payloads]


def _tunnel_pair(medium):
    from grtpu_torch.digital.modems import GmskModem
    from grtpu_torch.digital.tunnel import CsMac, LoopIface, PacketPhy

    nodes = []
    for _ in range(2):
        iface = LoopIface()
        mac = CsMac(iface)
        phy = PacketPhy(GmskModem(samples_per_symbol=4, device="cpu"), medium,
                        mac.phy_rx_callback)
        mac.set_phy(phy)
        nodes.append((iface, mac, phy))
    return nodes


def _stop(nodes, threads):
    for iface, _, _ in nodes:
        iface.inject(b"")                 # EOF ends each MAC loop
    for t in threads:
        t.join(timeout=10)
    for _, _, phy in nodes:
        phy.stop(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_tunnel_two_node_exchange():
    """TestTunnelMac: two carrier-sense MACs over one medium exchange their
    payloads both ways."""
    from grtpu_torch.digital.tunnel import Medium

    nodes = _tunnel_pair(Medium(sample_rate=1e7))
    threads = [mac.start() for _, mac, _ in nodes]
    try:
        pa = [b"ping %d" % i for i in range(3)]
        pb = [b"pong %d" % i for i in range(3)]
        for p in pa:
            nodes[0][0].inject(p)
        for p in pb:
            nodes[1][0].inject(p)
        assert nodes[1][0].wait_received(3, timeout=10.0), nodes[1][0].received
        assert nodes[0][0].wait_received(3, timeout=10.0), nodes[0][0].received
    finally:
        _stop(nodes, threads)
    assert sorted(nodes[1][0].received) == sorted(pa)
    assert sorted(nodes[0][0].received) == sorted(pb)


def test_tunnel_carrier_sense_backoff():
    """A busy medium defers the transmission (exponential back-off), and
    the payload is delivered well inside the wait's timeout (the port's
    LoopIface wakes every waiter; grtpu's wakes one, and a waiter on the
    received count can sleep to its timeout)."""
    import time

    from grtpu_torch.digital.tunnel import Medium

    medium = Medium(sample_rate=1e7)
    nodes = _tunnel_pair(medium)
    threads = [mac.start() for _, mac, _ in nodes]
    try:
        medium.occupy(0.25)
        t0 = time.monotonic()
        nodes[0][0].inject(b"hello")
        assert nodes[1][0].wait_received(1, timeout=10.0)
        assert time.monotonic() - t0 < 5.0
    finally:
        _stop(nodes, threads)
    assert nodes[0][1].backoffs >= 1
    assert nodes[1][0].received == [b"hello"]


def test_open_tun_interface_is_ported_whole():
    """open_tun_interface keeps grtpu's ioctl request (no test opens
    /dev/net/tun)."""
    import inspect

    from grtpu.digital import tunnel as jt
    from grtpu_torch.digital import tunnel as tt

    assert (tt.TUNSETIFF, tt.IFF_TUN, tt.IFF_TAP, tt.IFF_NO_PI) == \
        (jt.TUNSETIFF, jt.IFF_TUN, jt.IFF_TAP, jt.IFF_NO_PI)
    assert inspect.getsource(tt.open_tun_interface) == \
        inspect.getsource(jt.open_tun_interface)
