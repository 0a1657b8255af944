"""grtpu_torch's flowgraph compiler held against grtpu: the block registry,
JSON / YAML specs, generated scripts, the command line and ``.grc`` XML.

The ``.grc`` cases write small GRC 3.5 XML files into ``tmp_path`` (the
schema ``parse_grc`` reads: ``<flow_graph><block><key>``, ``<param><key>
<value>``, ``<connection>``) and run them through both packages'
``load_grc`` / ``run_grc``: integer streams must be equal, float streams
within 1e-5.  The WBFM spec runs on a 2^16-sample capture: the port's
default (``mxu``) path within 1e-5 of grtpu, its ``impl: kernel`` path (the
kernel's plain twin on the CPU) within 1e-4.  The command line runs in a
subprocess with ``--device cpu``.
"""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _exact_rotator  # noqa: E402
import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu.blocks import gengen as jgen  # noqa: E402
from grtpu.grc import flowgraph as jflow, grcxml as jxml  # noqa: E402
from grtpu.grc import registry as jreg  # noqa: E402
from grtpu.trellis import fsm as jfsm  # noqa: E402
from grtpu_torch.grc import flowgraph as tflow, grcxml as txml  # noqa: E402
from grtpu_torch.grc import registry as treg  # noqa: E402
from grtpu_torch.io import file as tfile  # noqa: E402
from grtpu_torch.trellis import fsm as tfsm  # noqa: E402
from grtpu_torch.utils import firdes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(REPO)}
REFUSED = "gr_peak_detector2_fb"


def cli(*args, timeout=120):
    r = subprocess.run([sys.executable, "-m", "grtpu_torch.grc", *args],
                       capture_output=True, text=True, env=ENV, cwd=REPO,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


# --------------------------------------------------------------- registry
def test_registry_keys_are_grtpus_less_the_refused_one():
    assert set(treg.BLOCK_REGISTRY) == set(jreg.BLOCK_REGISTRY) - {REFUSED}
    assert treg.STRUCTURAL_KEYS == jreg.STRUCTURAL_KEYS
    assert set(treg.UNSUPPORTED_KEYS) == {REFUSED}


@pytest.mark.parametrize("key", sorted(set(jreg.BLOCK_REGISTRY) - {REFUSED}))
def test_registry_factory_is_the_counterpart(key):
    """Each key's factory is the port's counterpart of grtpu's: the class of
    the same name in the module of the same path, or the factory function
    of the same name."""
    j, t = jreg.BLOCK_REGISTRY[key], treg.BLOCK_REGISTRY[key]
    assert t.__qualname__ == j.__qualname__
    assert t.__module__ == "grtpu_torch" + j.__module__[len("grtpu"):]
    assert isinstance(t, type) == isinstance(j, type)


def test_grc_package_exports_grtpus_names():
    """grtpu.grc re-exports the compiler's names (it defines none itself,
    so the public-name test cannot hold it); the port exports the same."""
    import grtpu.grc
    import grtpu_torch.grc

    names = {n for n in vars(grtpu.grc) if not n.startswith("_")} - {
        "flowgraph", "registry", "grcxml"}
    assert names == {"FlowgraphSpec", "generate_script", "load_flowgraph",
                     "BLOCK_REGISTRY", "register_block"}
    assert all(hasattr(grtpu_torch.grc, n) for n in names)


def test_every_reference_grc_key_accounted_for():
    keys = (REPO / "tests" / "data" / "grc_reference_keys.txt").read_text()
    ref = [k.strip() for k in keys.splitlines() if k.strip()]
    assert len(ref) > 150
    missing = [k for k in ref if k not in treg.BLOCK_REGISTRY
               and k not in treg.STRUCTURAL_KEYS
               and k not in treg.UNSUPPORTED_KEYS]
    assert not missing


def test_peak_detector2_is_refused_where_grtpu_maps_it_to_peak_detector(
        tmp_path):
    """grtpu runs gr_peak_detector_XX's algorithm under the key; the port
    refuses it, naming the key and the reason, in make_block,
    FlowgraphSpec.build and generate_script."""
    assert jreg.BLOCK_REGISTRY[REFUSED] is jgen.PeakDetector
    spec = {"blocks": [{"id": "pk", "key": REFUSED, "params": {}}]}
    for call in (lambda: tflow.FlowgraphSpec.from_dict(spec).build(),
                 lambda: tflow.generate_script(
                     tflow.FlowgraphSpec.from_dict(spec)),
                 lambda: txml.make_block(REFUSED, "pk", {}, {})):
        with pytest.raises(ValueError, match=REFUSED) as e:
            call()
        assert "silently wrong" in str(e.value)


def test_xmlrpc_and_tcp_factories():
    deferred = treg.BLOCK_REGISTRY["xmlrpc_server"](addr="127.0.0.1",
                                                   port=18081)
    assert hasattr(deferred, "register")
    cli_ = treg.BLOCK_REGISTRY["xmlrpc_client"](addr="127.0.0.1", port=18081)
    assert hasattr(cli_, "callback")
    assert treg._GRC_DTYPES["complex"] is torch.complex64


# ----------------------------------------------------------- JSON / YAML
def dial_tone_spec():
    import yaml

    return yaml.safe_load((REPO / "examples" / "dial_tone.yml").read_text())


def test_dial_tone_json_spec_equals_grtpu(tmp_path, monkeypatch):
    """examples/dial_tone.yml as JSON: the same blocks, dtypes and output.
    The tones agree to 1e-6 (XLA's and torch's float32 sin differ in the
    last bit, 6.7e-8 at most here), grtpu's float32 ramps reduced before
    rounding as the port's are (``_exact_rotator``)."""
    _exact_rotator.install(monkeypatch)
    path = tmp_path / "dial_tone.json"
    path.write_text(json.dumps(dial_tone_spec()))
    spec_t = tflow.load_flowgraph(str(path))
    spec_j = jflow.load_flowgraph(str(path))
    g, byid_j = spec_j.build()
    grtpu.StreamExecutor(g, chunk_size=4096, donate=False).run(steps=8)
    g, byid_t = spec_t.build()
    grtpu_torch.StreamExecutor(g, chunk_size=4096, device="cpu").run(steps=8)
    a = np.asarray(byid_j["out"].captured[0])
    b = byid_t["out"].data()
    assert b.dtype == np.float32 and b.shape == a.shape == (32768,)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert list(byid_t) == list(byid_j)


def test_generate_script_runs_on_the_cpu(tmp_path):
    """``generate --device cpu`` renders a script over grtpu_torch that
    runs alone and builds the graph build() builds."""
    path = tmp_path / "dial_tone.json"
    path.write_text(json.dumps(dial_tone_spec()))
    src = cli("generate", str(path), "--device", "cpu")
    assert "jax" not in src and "device='cpu'" in src
    assert "device" not in tflow.generate_script(
        tflow.load_flowgraph(str(path))).split("StreamExecutor(")[1]
    script = tmp_path / "fg.py"
    script.write_text(src)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=ENV, timeout=120)
    assert r.returncode == 0 and "flowgraph complete" in r.stdout, r.stderr
    ns = {}
    exec(compile(src, "<fg>", "exec"), ns)
    ns["ex"].run(steps=2)
    g, byid = tflow.load_flowgraph(str(path)).build()
    grtpu_torch.StreamExecutor(g, chunk_size=4096, device="cpu").run(steps=2)
    np.testing.assert_array_equal(ns["blocks"]["out"].data(),
                                  byid["out"].data())


def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the command line runs on the card: here, with no
    CUDA, it fails there rather than falling back to the CPU."""
    path = tmp_path / "dial_tone.json"
    path.write_text(json.dumps(dial_tone_spec()))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "grtpu_torch.grc", "run",
                        str(path)], capture_output=True, text=True, env=ENV,
                       timeout=120)
    assert r.returncode != 0 and "flowgraph complete" not in r.stdout
    assert "cuda" in r.stderr.lower()


def wbfm_capture(n=1 << 16, fs=2.048e6):
    t = np.arange(n) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    x = np.exp(1j * (2 * np.pi * 400e3 * t
                     + np.cumsum(2 * np.pi * 75e3 / fs * msg)))
    r = np.random.RandomState(16)
    return (x + 0.01 * (r.randn(n) + 1j * r.randn(n))).astype(np.complex64)


def wbfm_spec(cap, impl=None):
    taps = firdes.low_pass(1.0, 2.048e6, 100e3, 50e3)
    rcv = {"quad_rate": 256000.0, "audio_decimation": 8}
    if impl:
        rcv["impl"] = impl
    return {
        "options": {"chunk_size": 16384, "steps": 4, "id": "wbfm"},
        "blocks": [
            {"id": "src", "key": "gr_file_source", "params": {"path": cap}},
            {"id": "tuner", "key": "gr_freq_xlating_fir_filter_xxx",
             "params": {"decimation": 8, "taps": [float(v) for v in taps],
                        "center_freq": 400e3, "sampling_freq": 2.048e6}},
            {"id": "rcv", "key": "blks2_wfm_rcv", "params": rcv},
            {"id": "out", "key": "gr_vector_sink_x",
             "params": {"dtype": "float32"}}],
        "connections": [["src", 0, "tuner", 0], ["tuner", 0, "rcv", 0],
                        ["rcv", 0, "out", 0]]}


@pytest.fixture(scope="module")
def wbfm(tmp_path_factory):
    """The 2^16-sample capture on disk and grtpu's audio from the spec,
    its tuner's ramp (to 2e4 rad a chunk) reduced before rounding as the
    port's is (``_exact_rotator``)."""
    d = tmp_path_factory.mktemp("wbfm")
    cap = str(d / "cap.cfile")
    tfile.save_capture(cap, wbfm_capture())
    with pytest.MonkeyPatch.context() as mp:
        _exact_rotator.install(mp)
        g, byid = jflow.FlowgraphSpec.from_dict(wbfm_spec(cap)).build()
        grtpu.StreamExecutor(g, chunk_size=16384, donate=False).run(steps=4)
        return cap, np.asarray(byid["out"].captured[0])


@pytest.mark.parametrize("impl,tol", [(None, 1e-5), ("kernel", 1e-4)],
                         ids=["auto", "kernel"])
def test_wbfm_json_spec_equals_grtpu(wbfm, impl, tol):
    cap, ref = wbfm
    g, byid = tflow.FlowgraphSpec.from_dict(wbfm_spec(cap, impl)).build()
    assert byid["rcv"].audio_filter.impl == (impl or "mxu")
    grtpu_torch.StreamExecutor(g, chunk_size=16384, device="cpu").run(steps=4)
    got = byid["out"].data()
    assert got.shape == ref.shape == (1024,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_wfm_rcv_example_through_the_cli(tmp_path):
    """examples/wfm_rcv.yml, copied with its paths moved into tmp_path, run
    by ``python -m grtpu_torch.grc run ... --device cpu``: the WAV holds the
    1 kHz tone."""
    fs, fdev, n = 256e3, 75e3, 8192 * 16
    t = np.arange(n) / fs
    phi = np.cumsum(2 * np.pi * fdev * 0.5 * np.sin(2 * np.pi * 1000 * t)
                    / fs)
    cap, wav = tmp_path / "capture.cfile", tmp_path / "audio.wav"
    np.exp(1j * phi).astype(np.complex64).tofile(cap)
    text = (REPO / "examples" / "wfm_rcv.yml").read_text()
    text = text.replace("/tmp/wfm_capture.cfile", str(cap))
    text = text.replace("/tmp/wfm_audio.wav", str(wav))
    (tmp_path / "wfm_rcv.yml").write_text(text)
    out = cli("run", str(tmp_path / "wfm_rcv.yml"), "--device", "cpu")
    assert "on cpu" in out and "'wav': (16384,)" in out
    with wave.open(str(wav)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16) / 32768.0
    seg = pcm[2000:10000] * np.hanning(8000)
    fpk = np.fft.rfftfreq(8000, 1 / 32000.0)[np.abs(np.fft.rfft(seg)).argmax()]
    assert abs(fpk - 1000.0) < 8.0


# ------------------------------------------------------------------- .grc
def grc_file(path, blocks, connections):
    """Write a GRC 3.5 flow_graph: blocks are (key, {param: value}), every
    one with an ``id`` param; connections (src, src_port, dst, dst_port)."""
    out = ["<?xml version='1.0' encoding='ASCII'?>", "<flow_graph>",
           "  <timestamp>Sat Oct 17 00:00:00 2026</timestamp>"]
    for key, params in blocks:
        out.append(f"  <block>\n    <key>{key}</key>")
        for k, v in params.items():
            out.append(f"    <param>\n      <key>{k}</key>\n"
                       f"      <value>{escape(str(v))}</value>\n    </param>")
        out.append("  </block>")
    for s, sp, d, dp in connections:
        out.append(f"  <connection>\n    <source_block_id>{s}"
                   f"</source_block_id>\n    <sink_block_id>{d}"
                   f"</sink_block_id>\n    <source_key>{sp}</source_key>\n"
                   f"    <sink_key>{dp}</sink_key>\n  </connection>")
    out.append("</flow_graph>")
    Path(path).write_text("\n".join(out) + "\n")
    return str(path)


def tones_grc(tmp_path):
    """Two tones summed, through a virtual sink/source pair, scaled into a
    vector sink; ``ampl`` refers to ``scale``, defined after it; a
    disabled null sink hangs off the sum."""
    src = {"samp_rate": "samp_rate", "waveform": "gr.GR_SIN_WAVE",
           "amp": "ampl", "offset": "0", "type": "float"}
    blocks = [
        ("options", {"id": "tones"}),
        ("variable", {"id": "ampl", "value": "0.1 * scale"}),
        ("variable", {"id": "samp_rate", "value": "32000"}),
        ("variable", {"id": "scale", "value": "4"}),
        ("import", {"id": "import_0", "import": "import math"}),
        ("gr_sig_source_x", {"id": "src0", "freq": "350", **src}),
        ("gr_sig_source_x", {"id": "src1", "freq": "440", **src}),
        ("gr_add_xx", {"id": "add", "type": "float", "num_inputs": "2",
                       "vlen": "1"}),
        ("virtual_sink", {"id": "vs", "stream_id": "tones"}),
        ("virtual_source", {"id": "vsrc", "stream_id": "tones"}),
        ("gr_multiply_const_vxx", {"id": "mul", "type": "float",
                                   "const": "math.sqrt(4)", "vlen": "1"}),
        ("gr_vector_sink_x", {"id": "out", "type": "float", "vlen": "1"}),
        ("gr_null_sink", {"id": "dead", "type": "float", "vlen": "1",
                          "_enabled": "False"}),
    ]
    conns = [("src0", 0, "add", 0), ("src1", 0, "add", 1),
             ("add", 0, "vs", 0), ("vsrc", 0, "mul", 0),
             ("mul", 0, "out", 0), ("add", 0, "dead", 0)]
    return grc_file(tmp_path / "tones.grc", blocks, conns)


@pytest.mark.parametrize("scale", [None, 2], ids=["file", "override"])
def test_grc_tones_equal_grtpu(tmp_path, scale, monkeypatch):
    """grtpu's float32 ramps reduced before rounding as the port's are
    (``_exact_rotator``)."""
    _exact_rotator.install(monkeypatch)
    path = tones_grc(tmp_path)
    over = None if scale is None else {"scale": scale}
    outs = {}
    for kind, mod in (("j", jxml), ("t", txml)):
        kw = {} if kind == "j" else {"device": "cpu"}
        ex, byid = mod.run_grc(path, steps=4, chunk_size=1024,
                               overrides=over, **kw)
        outs[kind] = np.asarray(byid["out"].captured[0])
        assert "dead" not in byid and "vs" not in byid
    g, byid, options, env = txml.load_grc(path, over)
    assert options["id"] == "tones"
    assert env["ampl"] == pytest.approx(0.1 * (scale or 4))
    assert outs["t"].shape == outs["j"].shape == (4096,)
    np.testing.assert_allclose(outs["t"], outs["j"], rtol=0, atol=1e-5)
    peak = np.abs(outs["t"]).max()
    assert peak == pytest.approx(2 * 2 * 0.1 * (scale or 4), rel=0.02)


def test_grc_cli_set_override(tmp_path):
    path = tones_grc(tmp_path)
    out = cli("run", path, "--set", "scale=2", "--steps", "2",
              "--device", "cpu")
    assert "'out': (8192,)" in out


@pytest.mark.parametrize("mod", [jxml, txml], ids=["grtpu", "port"])
def test_grc_hardware_key_is_refused(tmp_path, mod):
    path = grc_file(tmp_path / "hw.grc", [
        ("options", {"id": "hw"}),
        ("uhd_usrp_source", {"id": "usrp"}),
        ("gr_null_sink", {"id": "sink", "type": "complex", "vlen": "1"})],
        [("usrp", 0, "sink", 0)])
    with pytest.raises(ValueError, match="needs radio hardware"):
        mod.load_grc(path)


def test_grc_wbfm_receiver_equals_grtpu(tmp_path, wbfm):
    """The tuner -> WBFM chain as a .grc file: taps as a firdes expression,
    the rates as variables; the adapters take impl auto (mxu here)."""
    cap, _ = wbfm
    path = grc_file(tmp_path / "wbfm.grc", [
        ("options", {"id": "wbfm"}),
        ("variable", {"id": "quad", "value": "samp_rate / decim"}),
        ("variable", {"id": "samp_rate", "value": "2048000"}),
        ("variable", {"id": "decim", "value": "8"}),
        ("gr_file_source", {"id": "src", "file": repr(cap),
                            "type": "complex", "repeat": "False"}),
        ("gr_freq_xlating_fir_filter_xxx", {
            "id": "tuner", "type": "ccc", "decim": "decim",
            "taps": "firdes.low_pass(1, samp_rate, 100e3, 50e3)",
            "center_freq": "400e3", "samp_rate": "samp_rate"}),
        ("blks2_wfm_rcv", {"id": "rcv", "quad_rate": "quad",
                           "audio_decimation": "8"}),
        ("gr_vector_sink_x", {"id": "out", "type": "float", "vlen": "1"})],
        [("src", 0, "tuner", 0), ("tuner", 0, "rcv", 0),
         ("rcv", 0, "out", 0)])
    _, jb = jxml.run_grc(path, steps=16)
    _, tb = txml.run_grc(path, steps=16, device="cpu")
    assert tb["rcv"].audio_filter.impl == "mxu"
    a, b = np.asarray(jb["out"].captured[0]), tb["out"].data()
    assert b.shape == a.shape == (1024,)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mod", [jxml, txml], ids=["grtpu", "port"])
def test_grc_xmlrpc_server_and_client_pair(tmp_path, mod):
    """xmlrpc_server in one .grc makes its variables remotely settable;
    the xmlrpc_client stubs of another push their variable expressions to
    the server's setters (the reference's xmlrpc_{server,client}.grc)."""
    import xmlrpc.client

    server = grc_file(tmp_path / "server.grc", [
        ("options", {"id": "server"}),
        ("variable", {"id": "freq", "value": "1000"}),
        ("variable", {"id": "ampl", "value": "1"}),
        ("xmlrpc_server", {"id": "srv", "addr": "localhost", "port": "0"}),
        ("gr_sig_source_x", {"id": "src", "samp_rate": "32000",
                             "waveform": "gr.GR_COS_WAVE", "freq": "freq",
                             "amp": "ampl", "offset": "0", "type": "float"}),
        ("gr_vector_sink_x", {"id": "out", "type": "float", "vlen": "1"})],
        [("src", 0, "out", 0)])
    g, byid, _, env = mod.load_grc(server)
    srv = byid["srv"]
    changed = []
    srv.on_set = lambda k, v: changed.append((k, v))
    try:
        assert "srv" in byid and srv.port > 0
        proxy = xmlrpc.client.ServerProxy(f"http://localhost:{srv.port}",
                                          allow_none=True)
        proxy.set_freq(2000)
        assert env["freq"] == 2000 and proxy.get_freq() == 2000
        assert changed == [("freq", 2000)]
        client = grc_file(tmp_path / "client.grc", [
            ("options", {"id": "client"}),
            ("variable", {"id": "ampl", "value": "0.1"}),
            ("variable", {"id": "freq", "value": "3000"}),
            ("xmlrpc_client", {"id": "c_ampl", "addr": "localhost",
                               "port": str(srv.port), "callback": "set_ampl",
                               "variable": "ampl"}),
            ("xmlrpc_client", {"id": "c_freq", "addr": "localhost",
                               "port": str(srv.port), "callback": "set_freq",
                               "variable": "freq * 2"})], [])
        _, byid2, _, env2 = mod.load_grc(client)
        for k in ("c_ampl", "c_freq"):
            assert byid2[k].push() is True
        assert env["ampl"] == 0.1 and env["freq"] == 6000
        assert changed[1:] == [("ampl", 0.1), ("freq", 6000)]
    finally:
        srv.stop()


def test_grc_trellis_encoder_equals_grtpu(tmp_path):
    """trellis_encoder_xx over an FSM file the port writes (byte-identical
    to grtpu's): the encoded shorts are equal."""
    fsm_t = tfsm.FSM.from_convolutional(1, 2, [7, 5])
    fsm_t.write_fsm_txt(str(tmp_path / "t.fsm"))
    jfsm.FSM.from_convolutional(1, 2, [7, 5]).write_fsm_txt(
        str(tmp_path / "j.fsm"))
    assert (tmp_path / "t.fsm").read_bytes() == (tmp_path / "j.fsm").read_bytes()
    bits = np.random.RandomState(17).randint(0, 2, 512).tolist()
    path = grc_file(tmp_path / "enc.grc", [
        ("options", {"id": "enc"}),
        ("gr_vector_source_x", {"id": "src", "type": "short",
                                "vector": repr(bits), "repeat": "False",
                                "vlen": "1"}),
        ("trellis_encoder_xx", {"id": "enc", "type": "ss",
                                "fsm_args": repr(str(tmp_path / "t.fsm")),
                                "init_state": "0"}),
        ("gr_vector_sink_x", {"id": "out", "type": "short", "vlen": "1"})],
        [("src", 0, "enc", 0), ("enc", 0, "out", 0)])
    _, jb = jxml.run_grc(path, steps=1, chunk_size=512)
    _, tb = txml.run_grc(path, steps=1, chunk_size=512, device="cpu")
    a, b = np.asarray(jb["out"].captured[0]), tb["out"].data()
    assert b.dtype == np.int16 and b.shape == (512,)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, fsm_t.encode(np.asarray(bits)))
