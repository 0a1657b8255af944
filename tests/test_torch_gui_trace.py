"""grtpu_torch's GUI sinks, trace tools and utilities held against grtpu.

The sinks' display arrays (spectra, waterfall rasters, trigger frames,
constellation points, the number meter's trajectory, histograms) within
1e-5 of grtpu's on the same input; PNG renders where matplotlib imports;
``prefs`` files and environment overrides, ``filter_design`` taps, the plot
CLI; the scaffolded module's QA test; ``TracedExecutor`` lines,
``validate_state``, ``block_timings`` and ``profile``; and the imports that
must work without PyYAML or matplotlib.
"""

import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import grtpu  # noqa: E402
import grtpu_torch  # noqa: E402
from grtpu import gui as jgui  # noqa: E402
from grtpu.models import fm as jfm  # noqa: E402
from grtpu.utils import filter_design as jfd, prefs as jprefs  # noqa: E402
from grtpu.utils import trace as jtrace  # noqa: E402
from grtpu_torch import gui as tgui  # noqa: E402
from grtpu_torch.models import fm as tfm  # noqa: E402
from grtpu_torch.utils import filter_design as tfd, prefs as tprefs  # noqa: E402
from grtpu_torch.utils import plot as tplot, scaffold as tscaffold  # noqa: E402
from grtpu_torch.utils import trace as ttrace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PKG = {"j": dict(pkg=grtpu, lib=jnp, gui=jgui, fm=jfm),
       "t": dict(pkg=grtpu_torch, lib=torch, gui=tgui, fm=tfm)}


def run_into(kind, make, x, chunk=1024):
    m = PKG[kind]
    sink = make(m["gui"], m["lib"])
    g = m["pkg"].Graph()
    g.connect(g.add_input(m["pkg"].Port(sink.in_ports[0].dtype)), sink)
    if kind == "j":
        grtpu.StreamExecutor(g, chunk_size=chunk, donate=False).run(
            jnp.asarray(x))
    else:
        grtpu_torch.StreamExecutor(g, chunk_size=chunk, device="cpu").run(x)
    return sink


def both(make, x, chunk=1024):
    return run_into("j", make, x, chunk), run_into("t", make, x, chunk)


def close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def cnoise(n, seed):
    r = np.random.RandomState(seed)
    return (r.randn(n) + 1j * r.randn(n)).astype(np.complex64)


SPECTRA = [
    ("fft-complex", lambda g, lib: g.FftSink(256, 32000.0),
     lambda: (0.5 * np.exp(2j * np.pi * 4000 / 32000 * np.arange(8192))
              + 0.01 * cnoise(8192, 1)).astype(np.complex64)),
    ("fft-avg", lambda g, lib: g.FftSink(64, 8000.0, avg_alpha=0.1,
                                         window="hann"),
     lambda: cnoise(4096, 2)),
    ("fft-real", lambda g, lib: g.FftSink(128, 8000.0, dtype=lib.float32),
     lambda: np.sin(2 * np.pi * 1000 / 8000 * np.arange(4096))
     .astype(np.float32)),
    ("waterfall", lambda g, lib: g.WaterfallSink(128, 8000.0),
     lambda: cnoise(4096, 3)),
]


@pytest.mark.parametrize("make,data", [s[1:] for s in SPECTRA],
                         ids=[s[0] for s in SPECTRA])
def test_spectra_equal_grtpu(make, data, tmp_path):
    j, t = both(make, data())
    close(j.spectra(), t.spectra())
    close(j.spectrum(), t.spectrum())
    np.testing.assert_array_equal(j.freqs(), t.freqs())
    close(j._display(j.spectrum()), t._display(t.spectrum()))
    out = t.render(str(tmp_path / "s.png"))
    assert os.path.getsize(out) > 5000


def test_scope_frames_equal_grtpu(tmp_path):
    x = np.sin(2 * np.pi * 10 * np.arange(8192) / 1000.0).astype(np.float32)
    j, t = both(lambda g, lib: g.ScopeSink(frame_size=256,
                                           sample_rate=1000.0), x)
    for kw in (dict(level=0.0, slope="pos"), dict(level=0.5, slope="neg"),
               dict(level=5.0, mode="auto", max_frames=4)):
        fj, ft = j.frames(**kw), t.frames(**kw)
        assert len(fj) == len(ft) > 0
        for a, b in zip(fj, ft):
            close(a, b)
    assert os.path.getsize(t.render(str(tmp_path / "scope.png"))) > 5000


def test_const_number_histo_equal_grtpu(tmp_path):
    pts = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], np.complex64)
    x = np.repeat(pts, 256) + 0.05 * cnoise(1024, 4)
    j, t = both(lambda g, lib: g.ConstSink(max_points=512), x)
    close(j.points(), t.points())
    assert os.path.getsize(t.render(str(tmp_path / "c.png"))) > 5000

    x = (3.25 + 0.1 * np.random.RandomState(5).randn(4096)).astype(np.float32)
    j, t = both(lambda g, lib: g.NumberSink(avg_alpha=0.05), x)
    close(j.trajectory(), t.trajectory())
    assert t.value() == pytest.approx(j.value(), abs=1e-5)
    assert os.path.getsize(t.render(str(tmp_path / "n.png"))) > 5000
    j, t = both(lambda g, lib: g.NumberSink(avg_alpha=0.05,
                                            dtype=lib.complex64),
                np.full(2048, 3.0j, np.complex64))
    close(j.trajectory(), t.trajectory())

    x = np.random.RandomState(6).randn(8192).astype(np.float32)
    j, t = both(lambda g, lib: g.HistoSinkDisplay(nbins=32), x)
    (cj, ej), (ct, et) = j.histogram(), t.histogram()
    np.testing.assert_array_equal(cj, ct)
    close(ej, et)
    assert os.path.getsize(t.render(str(tmp_path / "h.png"))) > 5000


# ------------------------------------------------------------------ utils
def test_prefs_files_and_env_override_equal_grtpu(tmp_path, monkeypatch):
    conf = tmp_path / "config.conf"
    conf.write_text("[runtime]\nchunk_size = 2048\nverbose = yes\n"
                    "[fir]\nimpl = kernel\nratio = 0.25\n")
    pj, pt = jprefs.Prefs(paths=[str(conf)]), tprefs.Prefs(paths=[str(conf)])
    monkeypatch.setenv("GRTPU_FIR_IMPL", "mxu")
    monkeypatch.setenv("GRTPU_RUNTIME_MISSING", "7")
    for sec, opt, dflt, getter in (
            ("runtime", "chunk_size", 1024, "get_long"),
            ("runtime", "verbose", False, "get_bool"),
            ("fir", "impl", "", "get_string"),
            ("fir", "ratio", 0.0, "get_double"),
            ("runtime", "missing", 3, "get_long"),
            ("nope", "x", 5, "get_long")):
        a = getattr(pj, getter)(sec, opt, dflt)
        b = getattr(pt, getter)(sec, opt, dflt)
        assert a == b and type(a) is type(b)
    assert pt.get_string("fir", "impl") == "mxu"
    assert pt.has_section("fir") and pt.has_option("runtime", "missing")
    monkeypatch.setattr(tprefs, "_store_dir", lambda: str(tmp_path))
    tprefs.set_pref("vmcircbuf_default_factory", "mmap")
    assert tprefs.get_pref("vmcircbuf_default_factory") == "mmap"
    assert tprefs.get_pref("nope", "dflt") == "dflt"


DESIGNS = [
    ["lowpass", "--fs", "48000", "--cutoff", "8000", "--transition", "2000"],
    ["lowpass", "--fs", "48000", "--cutoff", "8000", "--ntaps", "63",
     "--window", "kaiser"],
    ["highpass", "--fs", "8000", "--cutoff", "1000", "--transition", "400",
     "--window", "blackman"],
    ["bandpass", "--fs", "48000", "--cutoff", "4000", "--cutoff2", "8000",
     "--transition", "1000"],
    ["rrc", "--fs", "4", "--symbol-rate", "1", "--alpha", "0.35"],
    ["gaussian", "--spb", "4", "--bt", "0.3"],
    ["hilbert", "--ntaps", "33"],
    ["optlow", "--fs", "48000", "--cutoff", "8000", "--stop", "10000",
     "--ripple", "0.5", "--atten", "60"],
]


@pytest.mark.parametrize("argv", DESIGNS, ids=[d[0] + str(i)
                                               for i, d in enumerate(DESIGNS)])
def test_filter_design_taps_identical(argv, tmp_path, capsys):
    tfd.main(argv + ["--save", str(tmp_path / "t.f32")])
    out_t = capsys.readouterr().out
    jfd.main(argv + ["--save", str(tmp_path / "j.f32")])
    out_j = capsys.readouterr().out
    assert (tmp_path / "t.f32").read_bytes() == (tmp_path / "j.f32").read_bytes()
    assert out_t.replace("t.f32", "") == out_j.replace("j.f32", "")


def test_filter_design_and_plot_render(tmp_path):
    png = str(tmp_path / "lp.png")
    tfd.main(["lowpass", "--fs", "48000", "--cutoff", "8000",
              "--transition", "2000", "--plot", png])
    assert os.path.getsize(png) > 5000
    x = cnoise(4096, 7)
    cap = str(tmp_path / "c.cfile")
    x.tofile(cap)
    for kind in ("psd", "time", "fft", "spec", "const"):
        out = str(tmp_path / f"{kind}.png")
        tplot.main([kind, cap, "--rate", "1e6", "--out", out])
        assert os.path.getsize(out) > 5000


def test_scaffolded_module_passes_its_qa_test(tmp_path):
    root = tscaffold.create("my_radio", str(tmp_path))
    src = Path(root, "my_radio", "blocks.py").read_text()
    assert "jax" not in src and "grtpu_torch.runtime.block" in src
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "tests"], cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": f"{root}:{REPO}"})
    assert r.returncode == 0 and "1 passed" in r.stdout, r.stdout + r.stderr
    with pytest.raises(ValueError):
        tscaffold.create("not-an-identifier", str(tmp_path))


# ------------------------------------------------------------------ trace
def wfm_executor(kind):
    m = PKG[kind]
    g = m["pkg"].Graph()
    pin = g.add_input(m["pkg"].Port(m["lib"].complex64))
    pout = g.add_output(m["pkg"].Port(m["lib"].float32))
    g.connect(pin, m["fm"].WfmRcv(256e3, 8), pout)
    if kind == "j":
        return grtpu.StreamExecutor(g, chunk_size=2048, donate=False)
    return grtpu_torch.StreamExecutor(g, chunk_size=2048, device="cpu")


def strip_uids(text):
    return re.sub(r"_\d+", "", text)


def test_traced_executor_lines_equal_grtpu():
    """One line a step in grtpu's format: the same step indices, edges (block
    names without their instance numbers) and item counts."""
    iq = cnoise(2048, 8)
    lines = {}
    for kind in ("j", "t"):
        buf = io.StringIO()
        tx = (jtrace if kind == "j" else ttrace).TracedExecutor(
            wfm_executor(kind), file=buf, state_norms=True)
        for _ in range(3):
            tx.step(jnp.asarray(iq) if kind == "j" else iq)
        lines[kind] = buf.getvalue().strip().split("\n")
        assert tx.lines == lines[kind]
    assert len(lines["t"]) == 3
    for a, b in zip(lines["j"], lines["t"]):
        assert b.startswith(a.split(" wall_ms=")[0] + " wall_ms=")
        assert (strip_uids(b.split(" items=")[1].split(" tail_sums")[0])
                == strip_uids(a.split(" items=")[1].split(" tail_sums")[0]))
        tj = eval(a.split(" tail_sums=")[1])  # noqa: S307 - our own line
        tt = eval(b.split(" tail_sums=")[1])  # noqa: S307
        assert sorted(map(strip_uids, tj)) == sorted(map(strip_uids, tt))
        np.testing.assert_allclose(sorted(tt.values()), sorted(tj.values()),
                                   rtol=1e-4, atol=1e-4)


def test_block_timings_keys_equal_grtpu():
    j = jtrace.block_timings(wfm_executor("j"), iters=3)
    t = ttrace.block_timings(wfm_executor("t"), iters=3)
    assert [strip_uids(k) for k in t] == [strip_uids(k) for k in j]
    assert all(v >= 0 for v in t.values()), t


def test_validate_state_clean_and_injected_nan():
    """A clean run reports nothing; a NaN + Inf written into the quadrature
    demodulator's complex halo tail reads "2 non-finite" in both packages;
    a tail of another shape is a structure problem."""
    bad = complex(float("nan"), float("inf"))
    ex = wfm_executor("t")
    ref = {k: v for k, v in ex.state.items()}
    ex.step(cnoise(2048, 9))
    assert ttrace.validate_state(ex, ref) == []
    assert ttrace.validate_state(ex) == []
    key = next(k for k, v in ex.state["tails"].items() if v.is_complex())
    ex.state["tails"][key][0] = bad
    probs = ttrace.validate_state(ex)
    assert len(probs) == 1 and probs[0].endswith(": 2 non-finite"), probs
    jex = wfm_executor("j")
    jex.step(jnp.asarray(cnoise(2048, 9)))
    key = next(k for k, v in jex.state["tails"].items()
               if v.dtype == jnp.complex64)
    jex.state["tails"][key] = jex.state["tails"][key].at[0].set(bad)
    assert [p.split(": ")[1] for p in jtrace.validate_state(jex)] == [
        "2 non-finite"]
    ex.state["tails"] = {k: v[:-1] for k, v in ex.state["tails"].items()}
    assert any("->" in p for p in ttrace.validate_state(ex, ref))


def test_profile_writes_a_chrome_trace(tmp_path):
    assert ttrace.high_res_timer_now() > 0
    ex = wfm_executor("t")
    with ttrace.profile(str(tmp_path / "tb")) as prof:
        ex.step(cnoise(2048, 10))
    traces = list((tmp_path / "tb").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    assert len(prof.key_averages()) > 0


def test_imports_need_neither_yaml_nor_matplotlib():
    code = ("import sys\n"
            "sys.modules['yaml'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "import grtpu_torch.grc, grtpu_torch.gui, grtpu_torch.utils.trace\n"
            "import grtpu_torch.utils.plot, grtpu_torch.utils.filter_design\n"
            "from grtpu_torch.grc import FlowgraphSpec\n"
            "import numpy as np\n"
            "from grtpu_torch import Graph, StreamExecutor, Port\n"
            "import torch\n"
            "s = grtpu_torch.gui.FftSink(64, 8000.0)\n"
            "g = Graph(); g.connect(g.add_input(Port(torch.complex64)), s)\n"
            "StreamExecutor(g, chunk_size=256, device='cpu').run("
            "np.ones(256, np.complex64))\n"
            "print(s.spectrum().shape)\n"
            "try:\n"
            "    s.render('x.png')\n"
            "except ImportError:\n"
            "    print('no matplotlib')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["(64,)", "no", "matplotlib"]
