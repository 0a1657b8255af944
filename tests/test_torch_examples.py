"""grtpu_torch.examples held against grtpu's examples/ on the CPU.

Each test runs grtpu's example in-process (its ``main`` under a patched
``sys.argv``, or its functions) and the port's counterpart with
``--device cpu`` on the same arguments, at small sizes.  grtpu's side runs
once a module where several tests read it (module-scoped fixtures).
Tolerances, by example:

* howto_write_a_block: the printed QA lines equal; the blocks' outputs equal
  grtpu's through ``run_block``; the tag offsets [1, 4, 7] under ``step``,
  ``run(device_loop=True)`` and a 2-channel ``MeshExecutor`` (both modes);
* wfm_demod: the WAVs within 1 LSB (a 2^16-sample capture);
* stream_server: the audio within 1e-5 of grtpu's ``serve`` on the same
  datagrams (2^15 samples), on the UDP socket and on the native ring;
* benchmark_tx_rx: the printed per-packet lines equal, at 15 dB and at an
  SNR where some CRC fails (3 packets of 32 bytes);
* benchmark_ofdm: sync index and BER equal, ``cfo_est`` and |H| within 1e-4
  (2 frames, flat and multipath); the ``curve`` at 8 dB with ``ber_burst``
  and ``ber_streaming`` equal;
* digital_bert: BER equal, the frequency offset and the SNR probe within
  1e-3 relative (2 x 2^11 bits at 10 dB); all three probes, the timing
  offset included, within 1e-3 relative when the port's example is fed
  grtpu's transmitted samples (see ``test_digital_bert_same_samples``).
"""

import contextlib
import importlib
import io
import re
import socket
import sys
import threading
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch.examples import (  # noqa: E402
    benchmark_ofdm as tofdm, benchmark_tx_rx as ttxrx,
    digital_bert as tbert, howto_write_a_block as thowto,
    stream_server as tsrv, trellis_ber as tber, wfm_demod as twfm)

REPO = Path(__file__).resolve().parent.parent


def grtpu_example(name):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module(f"examples.{name}")


def printed(fn, *args, argv=None):
    """The lines ``fn(*args)`` prints, with ``sys.argv`` set to ``argv``
    while it runs (grtpu's example mains read it)."""
    saved = sys.argv
    buf = io.StringIO()
    try:
        if argv is not None:
            sys.argv = argv
        with contextlib.redirect_stdout(buf):
            fn(*args)
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines()


def run_grtpu(name, args):
    return printed(grtpu_example(name).main, argv=[f"{name}.py"] + args)


def run_port(module, args):
    return printed(module.main, args + ["--device", "cpu"])


def free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fm_signal(n, fs=256e3, seed=3):
    """One WBFM station at baseband: a 1 kHz tone at 75 kHz deviation,
    with noise."""
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    x = np.exp(1j * np.cumsum(2 * np.pi * 75e3 / fs * msg))
    r = np.random.RandomState(seed)
    return (x + 0.01 * (r.randn(n) + 1j * r.randn(n))).astype(np.complex64)


EXAMPLES = {"howto_write_a_block": thowto, "wfm_demod": twfm,
            "stream_server": tsrv, "trellis_ber": tber,
            "benchmark_tx_rx": ttxrx, "benchmark_ofdm": tofdm,
            "digital_bert": tbert}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_keeps_grtpus_names(name):
    """Every function and class grtpu's example defines (``main``,
    ``serve``, the ``sim_*``, ``curve``, ``_make_burst``, the blocks and
    the ``qa_*``) has its counterpart of the same name in the port's."""
    import inspect

    j = grtpu_example(name)
    names = {n for n, v in vars(j).items()
             if (inspect.isfunction(v) or inspect.isclass(v))
             and v.__module__ == j.__name__}
    assert names
    assert not {n for n in names if not hasattr(EXAMPLES[name], n)}


# ------------------------------------------------------ howto_write_a_block
def test_howto_qa_lines_equal():
    jh = grtpu_example("howto_write_a_block")
    ref = printed(lambda: (jh.qa_square_ff(), jh.qa_square_accum_ff(),
                           jh.qa_threshold_tag_ff()))
    got = run_port(thowto, [])
    assert got == ref and len(got) == 3
    assert all(": OK" in line for line in got)


@pytest.mark.parametrize("name,chunk", [("SquareFF", 16), ("SquareAccumFF", 7),
                                        ("ThresholdTagFF", 8)])
def test_howto_blocks_equal_grtpu(name, chunk):
    from grtpu.utils.testing import run_block as jrun
    from grtpu_torch.utils.testing import run_block as trun

    jh = grtpu_example("howto_write_a_block")
    x = np.random.RandomState(4).randn(56).astype(np.float32) * 2
    ref = jrun(getattr(jh, name)(), x, chunk_size=chunk)
    got = trun(getattr(thowto, name)(), x, chunk_size=chunk, device="cpu")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


def tag_graph(mesh_channels=None):
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch.blocks.gengen import VectorSink
    from grtpu_torch.runtime.mesh_executor import MeshExecutor, make_mesh

    g = Graph()
    pin = g.add_input(Port(torch.float32))
    s = VectorSink(dtype=torch.float32)
    g.connect(pin, thowto.ThresholdTagFF(1.0), s)
    if mesh_channels is None:
        return StreamExecutor(g, chunk_size=4, device="cpu"), s
    mesh = make_mesh(mesh_channels, ["cpu"] * mesh_channels, time=1)
    return MeshExecutor(g, mesh, mesh_channels, chunk_size=4), s


QA_SRC = np.array([0, 2, 0, 0, 3, 3, 0, 2], np.float32)


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["step", "device_loop"])
def test_threshold_tags_single_device(device_loop):
    """qa_threshold_tag_ff's stream (crossings span chunks of 4) in both
    run modes: the offsets [1, 4, 7], the output equal to the input."""
    ex, s = tag_graph()
    ex.run(QA_SRC, device_loop=device_loop)
    assert sorted(t.offset for t in ex.sink_tags[s.name]) == [1, 4, 7]
    assert all(t.key == "rising" for t in ex.sink_tags[s.name])
    np.testing.assert_array_equal(s.data(), QA_SRC)


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["step", "device_loop"])
def test_threshold_tags_mesh_two_channels(device_loop):
    """The tag block under a 2-channel MeshExecutor: channel 0 carries the
    QA stream, channel 1 the same stream delayed by one sample; each
    channel's tags are its own."""
    ex, s = tag_graph(mesh_channels=2)
    x = np.stack([QA_SRC, np.concatenate([[0], QA_SRC[:-1]])])
    ex.run(x, device_loop=device_loop)
    offs = [sorted(t.offset for t in ex.sink_tags_chan(s.name, c))
            for c in range(2)]
    assert offs == [[1, 4, 7], [2, 5]]


# ---------------------------------------------------------------- wfm_demod
@pytest.fixture(scope="module")
def wfm_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wfm_demod")
    cap = tmp / "fm.cfile"
    fm_signal(1 << 16).tofile(cap)
    args = ["--rate", "256k", "--decim", "8", "--chunk", "16384"]
    j_wav, t_wav = str(tmp / "grtpu.wav"), str(tmp / "port.wav")
    ref = run_grtpu("wfm_demod", [str(cap), j_wav] + args)
    got = run_port(twfm, [str(cap), t_wav] + args)
    return ref, got, j_wav, t_wav


def test_wfm_demod_lines_equal(wfm_runs):
    ref, got, j_wav, t_wav = wfm_runs
    assert [line.replace(t_wav, "WAV") for line in got] == \
        [line.replace(j_wav, "WAV") for line in ref]
    assert got[0] == "65536 samples @ 256000 Hz"


def test_wfm_demod_wav_within_one_lsb(wfm_runs):
    import wave

    _, _, j_wav, t_wav = wfm_runs
    pcm = []
    for path in (j_wav, t_wav):
        with wave.open(path) as w:
            assert w.getframerate() == 32000
            pcm.append(np.frombuffer(w.readframes(w.getnframes()),
                                     np.int16).astype(np.int32))
    assert pcm[0].shape == pcm[1].shape == (8192,)
    assert np.abs(pcm[0] - pcm[1]).max() <= 1
    assert np.abs(pcm[1]).max() > 20000     # normalised audio, not silence


# ------------------------------------------------------------ stream_server
SERVICE_N = 1 << 15
SERVICE_CHUNK = 8192          # serve()'s default chunk
SERVICE_DECIM = 8


def run_service(serve, **kw):
    """Drive ``serve`` on a thread over localhost UDP in lock step: each
    chunk of samples is sent after the previous chunk's audio came back,
    so no socket buffer overflows.  Returns (counts, audio)."""
    from grtpu_torch.io.udp import UdpSink, UdpSource

    x = fm_signal(SERVICE_N, seed=21)
    in_port = free_port()
    audio_rx = UdpSource("127.0.0.1", 0, np.float32, timeout=30.0)
    ready, result = threading.Event(), {}

    def server():
        result["counts"] = serve(
            in_port, "127.0.0.1", audio_rx.sock.getsockname()[1],
            audio_decim=SERVICE_DECIM, in_host="127.0.0.1",
            on_ready=ready.set, **kw)

    th = threading.Thread(target=server)
    th.start()
    got = []
    try:
        assert ready.wait(timeout=120), "the service never became ready"
        tx = UdpSink("127.0.0.1", in_port, np.complex64)
        for c in range(SERVICE_N // SERVICE_CHUNK):
            tx.write_items(x[c * SERVICE_CHUNK:(c + 1) * SERVICE_CHUNK])
            a = audio_rx.read_items(SERVICE_CHUNK // SERVICE_DECIM)
            assert a is not None, f"no audio for chunk {c}"
            got.append(a)
        tx.close()              # the zero-length datagram ends the service
    finally:
        th.join(timeout=60)
        audio_rx.close()
    assert not th.is_alive()
    return result["counts"], np.concatenate(got)


@pytest.fixture(scope="module")
def grtpu_service():
    return run_service(grtpu_example("stream_server").serve, native=False)


@pytest.mark.parametrize("native", [False, True], ids=["socket", "ring"])
def test_stream_server_audio_matches_grtpu(grtpu_service, native):
    ref_counts, ref = grtpu_service
    counts, audio = run_service(tsrv.serve, native=native, device="cpu")
    assert counts == ref_counts == (SERVICE_N, SERVICE_N // SERVICE_DECIM)
    np.testing.assert_allclose(audio, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------- benchmark_tx_rx
# an SNR a modulation loses some packets at (3 packets of 32 bytes): both
# CRC outcomes occur there
LOSSY_SNR = {"gmsk": 8.0, "dbpsk": 1.0, "4fsk": 6.0}


@pytest.mark.parametrize("snr", ["clean", "lossy"])
@pytest.mark.parametrize("modulation", ["gmsk", "dbpsk", "4fsk"])
def test_benchmark_tx_rx_lines_equal(modulation, snr):
    db = 15.0 if snr == "clean" else LOSSY_SNR[modulation]
    args = ["--modulation", modulation, "--snr", str(db), "-n", "3",
            "--size", "32"]
    ref = run_grtpu("benchmark_tx_rx", args)
    got = run_port(ttxrx, args)
    assert got == ref
    crc = [line for line in got if " crc " in line]
    assert len(crc) == 3
    if snr == "clean":
        assert got[-1].startswith("3/3 packets received intact")
    else:
        assert any("crc BAD" in line for line in crc)
        assert any("crc OK" in line for line in crc)


# ----------------------------------------------------------- benchmark_ofdm
def recording(cls, into):
    """``cls.demodulate`` that also keeps each call's result on the host."""
    real = cls.demodulate

    def demodulate(self, x, nsym):
        out = real(self, x, nsym)
        bits, chan, cfo, d = (np.asarray(v.cpu() if isinstance(
            v, torch.Tensor) else v) for v in out)
        into.append((bits, chan, float(cfo), int(d)))
        return out

    return demodulate


@pytest.fixture(scope="module", params=["flat", "multipath"])
def ofdm_runs(request):
    from grtpu.digital import ofdm as jofdm
    from grtpu_torch.digital import ofdm as tofdm_mod

    args = ["--snr", "18", "--frames", "2"] + (
        ["--multipath"] if request.param == "multipath" else [])
    recs = {"grtpu": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jofdm.OfdmModem, "demodulate",
                   recording(jofdm.OfdmModem, recs["grtpu"]))
        mp.setattr(tofdm_mod.OfdmModem, "demodulate",
                   recording(tofdm_mod.OfdmModem, recs["port"]))
        ref = run_grtpu("benchmark_ofdm", args)
        got = run_port(tofdm, args)
    return ref, got, recs["grtpu"], recs["port"]


def test_ofdm_sync_and_ber_equal(ofdm_runs):
    ref, got, jr, tr = ofdm_runs
    assert len(jr) == len(tr) == 2
    for (jb, _, _, jd), (tb, _, _, td) in zip(jr, tr):
        assert td == jd
        np.testing.assert_array_equal(tb, jb)
    sync = re.compile(r"sync@ *(\d+) .* ber=([0-9.]+)")
    assert [sync.search(line).groups() for line in got[:2]] == \
        [sync.search(line).groups() for line in ref[:2]]
    assert got[-1] == ref[-1] and got[-1].startswith("2/2 frames")


def test_ofdm_cfo_and_channel_within_1e_4(ofdm_runs):
    _, _, jr, tr = ofdm_runs
    for (_, jc, jf, _), (_, tc, tf, _) in zip(jr, tr):
        assert abs(tf - jf) < 1e-4
        np.testing.assert_allclose(np.abs(tc), np.abs(jc), atol=1e-4,
                                   rtol=0)


def test_ofdm_curve_point_equal():
    """One point of ``--curve`` (8 dB, 2 frames): the burst modem's and the
    streaming receiver's BER equal grtpu's, and both are non-zero there."""
    args = dict(fft=64, symbols=8, multipath=False, frames=2, cfo=0.002)
    ref = printed(grtpu_example("benchmark_ofdm").curve, Namespace(**args),
                  (8,))
    got = printed(tofdm.curve, Namespace(device="cpu", **args), (8,))
    assert got == ref and len(got) == 1
    point = __import__("json").loads(got[0])
    assert point["ber_burst"] > 0 and point["ber_streaming"] > 0
    assert point["frames_streaming"] == 2


# ------------------------------------------------------------- digital_bert
BERT_ARGS = ["-n", str(1 << 11), "--chunks", "2", "--snr", "10"]
BERT_LINE = re.compile(r"Freq\. Offset: *(\S+) Hz  Timing Offset: *(\S+) ppm"
                       r"  Estimated SNR: *(\S+) dB  BER: (\S+)")


def bert_numbers(lines):
    return [tuple(float(v) for v in BERT_LINE.match(line).groups())
            for line in lines]


@pytest.fixture(scope="module")
def bert_runs():
    """grtpu's example, recording the clean samples its transmitter made,
    and the port's example on its own transmitter."""
    from grtpu.digital import bert as jbert

    sent = []
    real = jbert.BertTransmit.samples
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbert.BertTransmit, "samples",
                   lambda self, n: sent.append(real(self, n)) or sent[-1])
        ref = run_grtpu("digital_bert", BERT_ARGS)
    got = run_port(tbert, BERT_ARGS)
    return bert_numbers(ref), bert_numbers(got), sent


def test_digital_bert_lines(bert_runs):
    ref, got, _ = bert_runs
    assert len(got) == len(ref) == 2
    for (jf, _, js, jb), (tf, _, ts, tb) in zip(ref, got):
        assert tb == jb and tb < 0.05
        assert abs(tf - jf) <= 1e-3 * abs(jf)
        assert abs(ts - js) <= 1e-3 * abs(js)


def test_digital_bert_same_samples(bert_runs):
    """The port's example fed grtpu's transmitted samples: every probe of
    every line within 1e-3 relative, the timing offset too.  (On its own
    transmitter, whose samples differ from grtpu's by ~5e-7, the first
    chunk's timing offset differs by ~4%: the symbol-clock loop is still
    acquiring there and amplifies the difference; the receivers agree on
    one input.)"""
    ref, _, sent = bert_runs
    chunks = iter(sent)

    class GrtpuSamples(tbert.BertTransmit):
        def samples(self, nbits):
            return np.asarray(next(chunks))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbert, "BertTransmit", GrtpuSamples)
        got = bert_numbers(run_port(tbert, BERT_ARGS))
    assert len(got) == len(ref) == 2
    for j, t in zip(ref, got):
        assert t[3] == j[3]
        for a, b in zip(t[:3], j[:3]):
            assert abs(a - b) <= 1e-3 * abs(b)


# ----------------------------------------------------------- default device
@pytest.mark.parametrize("module,args", [
    (thowto, []),
    (tber, ["tcm", "-K", "8", "-r", "1"]),
    (ttxrx, ["-n", "1"]),
    (tofdm, ["--frames", "1"]),
    (tbert, ["-n", "64", "--chunks", "1"]),
], ids=["howto", "trellis_ber", "benchmark_tx_rx", "benchmark_ofdm",
        "digital_bert"])
def test_main_defaults_to_the_card(module, args):
    """Without --device an example runs on the card: here, with no CUDA, it
    fails there rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        printed(module.main, args)


def test_wfm_demod_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cap = tmp_path / "fm.cfile"
    fm_signal(1 << 12).tofile(cap)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        printed(twfm.main, [str(cap), str(tmp_path / "out.wav"),
                            "--chunk", "4096"])
    assert not (tmp_path / "out.wav").exists()
