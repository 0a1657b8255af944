"""grtpu_torch's numpy utilities and packaging, held against grtpu.

The port carries its own copies of grtpu's numpy-only modules (importing
``grtpu.utils.firdes`` would pull in the JAX runtime through
``grtpu/__init__.py``); these tests require the copies to give identical
output, and the port to import without JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu.utils import eng_notation as jeng  # noqa: E402
from grtpu.utils import firdes as jf  # noqa: E402
from grtpu.utils import optfir as jopt  # noqa: E402
from grtpu.utils import remez_engine as jrem  # noqa: E402
from grtpu.runtime import tags as jtags  # noqa: E402
from grtpu_torch.utils import eng_notation as teng  # noqa: E402
from grtpu_torch.utils import firdes as tf  # noqa: E402
from grtpu_torch.utils import optfir as topt  # noqa: E402
from grtpu_torch.utils import remez_engine as trem  # noqa: E402
from grtpu_torch.runtime import tags as ttags  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

DESIGNS = [
    ("low_pass", (1.0, 48000, 5000, 1000)),
    ("low_pass", (1.0, 256e3, 15e3, 3.2e3, "HAMMING")),
    ("low_pass", (2.0, 8000, 1000, 500, "KAISER", 7.0)),
    ("low_pass_2", (1.0, 32000, 4000, 63, "BLACKMAN")),
    ("high_pass", (1.0, 48000, 5000, 1000, "HANN")),
    ("band_pass", (1.0, 48000, 4000, 8000, 1000)),
    ("band_pass_2", (1.0, 48000, 4000, 8000, 101, "BLACKMAN_HARRIS")),
    ("complex_band_pass", (1.0, 256e3, 18.6e3, 19.4e3, 0.6e3)),
    ("band_reject", (1.0, 48000, 4000, 8000, 1000)),
    ("root_raised_cosine", (1.0, 8, 1, 0.35, 45)),
    ("gaussian", (1.0, 4, 0.3, 31)),
    ("hilbert", (65, "HAMMING")),
    ("inverse_sinc", (1.0, 48000, 12000)),
]


def _args(mod, args):
    return tuple(getattr(mod.Window, a) if isinstance(a, str) else a
                 for a in args)


@pytest.mark.parametrize("name,args", DESIGNS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(DESIGNS)])
def test_firdes_identical(name, args):
    a = getattr(jf, name)(*_args(jf, args))
    b = getattr(tf, name)(*_args(tf, args))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("win", list(jf.Window), ids=lambda w: w.name)
def test_window_identical(win):
    np.testing.assert_array_equal(jf.window(win, 57, 6.0),
                                  tf.window(tf.Window(int(win)), 57, 6.0))


def test_compute_ntaps_identical():
    for tw in (100.0, 1e3, 3.2e3, 4e3):
        assert (jf.compute_ntaps(256e3, tw, jf.Window.HAMMING)
                == tf.compute_ntaps(256e3, tw, tf.Window.HAMMING))


OPTFIR = [
    ("low_pass", (1.0, 64e3, 3000, 4500, 0.1, 60)),      # FmDemod's design
    ("low_pass", (1.0, 256e3, 15000, 16000, 0.1, 60)),
    ("high_pass", (1.0, 48000, 4000, 6000, 0.1, 60)),
    ("band_pass", (1.0, 48000, 3000, 4000, 8000, 9000, 0.1, 60)),
    ("complex_band_pass", (1.0, 48000, 3000, 4000, 8000, 9000, 0.1, 60)),
]


@pytest.mark.parametrize("name,args", OPTFIR,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTFIR)])
def test_optfir_identical(name, args):
    """Parks-McClellan designs are bit-identical (FmDemod's audio taps come
    from here, so every bound downstream rests on it)."""
    a = getattr(jopt, name)(*args)
    b = getattr(topt, name)(*args)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


REMEZ = [
    (65, [0, 0.2, 0.25, 0.5], [1, 0], [1, 1], "bandpass"),
    (64, [0, 0.2, 0.25, 0.5], [1, 0], [1, 1], "bandpass"),
    (61, [0.05, 0.45], [1], None, "hilbert"),
    (32, [0.0, 0.4], [1], None, "differentiator"),
]


@pytest.mark.parametrize("n,bands,des,w,ft", REMEZ,
                         ids=[f"{c[4]}-{c[0]}" for c in REMEZ])
def test_remez_engine_identical(n, bands, des, w, ft):
    np.testing.assert_array_equal(
        jrem.design(n, bands, des, w, ft), trem.design(n, bands, des, w, ft))


def test_pm_remez_and_order_estimates_identical():
    np.testing.assert_array_equal(
        jrem.pm_remez(64, [0, 0.4, 0.5, 1.0], [1, 1, 0, 0], [1, 1]),
        trem.pm_remez(64, [0, 0.4, 0.5, 1.0], [1, 1, 0, 0], [1, 1]))
    assert (jopt._lporder(0.1, 0.15, 0.01, 0.001)
            == topt._lporder(0.1, 0.15, 0.01, 0.001))
    np.testing.assert_array_equal(
        jopt.remez(33, [0, 0.1, 0.15, 0.5], [1, 0]),
        topt.remez(33, [0, 0.1, 0.15, 0.5], [1, 0]))
    assert jopt.stopband_atten_to_dev(60) == topt.stopband_atten_to_dev(60)
    assert jopt.passband_ripple_to_dev(0.1) == topt.passband_ripple_to_dev(0.1)


@pytest.mark.parametrize("v", [0.0, 1.0, 999.4, 1234.5, 2.048e6, 4.7e-9,
                               -33e3, 1e15])
def test_eng_notation_identical(v):
    assert jeng.num_to_str(v) == teng.num_to_str(v)
    for text in ("100M", "3.3u", "12", "1e3", "2.5G", " 47k "):
        assert jeng.str_to_num(text) == teng.str_to_num(text)


def test_tags_identical():
    tags = [jtags.Tag(10, "a", 1), jtags.Tag(25, "b", 2), jtags.Tag(3, "c")]
    ttag = [ttags.Tag(t.offset, t.key, t.value, t.srcid) for t in tags]
    for rate in (1.0, 0.125, 4.0):
        assert ([tuple(vars(t).values()) for t in jtags.propagate_tags(tags, rate)]
                == [tuple(vars(t).values())
                    for t in ttags.propagate_tags(ttag, rate)])
    assert ([t.offset for t in jtags.tags_in_window(tags, 3, 25)]
            == [t.offset for t in ttags.tags_in_window(ttag, 3, 25)])


PORTED_WHOLE = ["ops.fir", "ops.dsp", "ops.pfb", "ops.mmse_interp",
                "ops.fft_filter",
                "blocks.convert", "blocks.gengen", "blocks.stream",
                "blocks.filter", "blocks.analog", "blocks.pfb",
                "blocks.misc", "blocks.fftblk", "blocks.oscope",
                "blocks.selftest",
                "runtime.block", "runtime.graph", "runtime.tags",
                "runtime.executor", "runtime.optimize", "runtime.pmt",
                "runtime.msg", "runtime.top_block",
                "digital.constellation", "digital.modems", "digital.loops",
                "digital.blocks", "digital.generic_mod_demod",
                "digital.lfsr", "digital.bert", "digital.equalizers",
                "digital.cpm", "digital.modulation_utils",
                "digital.packet", "digital.correlate",
                "digital.packet_blocks", "digital.pkt", "digital.tunnel",
                "digital.ofdm",
                "vocoder", "vocoder.g711", "vocoder.g72x", "vocoder.cvsd",
                "vocoder.gsm", "vocoder.codec2",
                "models.fm", "models.dmr", "models.channel", "models.atsc",
                "models.atsc_rf", "models.digital_voice", "models.pager",
                "models.noaa",
                "utils.optfir", "utils.remez_engine", "utils.eng_notation",
                "utils.firdes", "utils.testing",
                "trellis.fsm", "trellis.interleaver",
                "trellis.fsm_utils", "trellis.algorithms", "trellis.blocks",
                "fec.rs", "fec.conv",
                "io.file", "io.udp", "io.tcp", "io.msgio", "io.xmlrpc",
                "io.xmlrpc_ctl", "io.native",
                "grc.registry", "grc.flowgraph", "grc.grcxml",
                "gui",
                "utils.trace", "utils.plot", "utils.prefs", "utils.scaffold",
                "utils.filter_design"]
# grtpu keeps the matmul mode in a module global; the port takes it per call
NOT_PORTED_BY_DESIGN = {"ops.fir": {"set_precision"}}


@pytest.mark.parametrize("module", PORTED_WHOLE)
def test_every_public_name_has_its_counterpart(module):
    """Each public function, class and typed factory that a wholly ported
    grtpu module defines is present in its grtpu_torch counterpart."""
    import functools
    import importlib
    import inspect

    j = importlib.import_module("grtpu." + module)
    t = importlib.import_module("grtpu_torch." + module)
    names = [n for n, v in vars(j).items() if not n.startswith("_")
             and ((inspect.isfunction(v) or inspect.isclass(v))
                  and v.__module__ == j.__name__
                  or isinstance(v, functools.partial))]
    # a package's public names are the ones it exports
    names += list(getattr(j, "__all__", ()))
    assert names
    missing = {n for n in names if not hasattr(t, n)}
    assert missing == NOT_PORTED_BY_DESIGN.get(module, set())


def test_import_pulls_in_no_jax():
    """Packaging guard: the port imports neither jax nor grtpu.  Every
    module of the package is found by walking it, so a module added later
    is held too, and all are imported in one fresh interpreter."""
    code = ("import importlib, pkgutil, sys, grtpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "grtpu_torch.__path__, 'grtpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'grtpu' "
            "or m.startswith('grtpu.'))\n"
            "print(len(mods), bad)\n"
            "sys.exit(1 if bad or len(mods) < 80 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_the_card():
    """Entry points run on the card unless the caller names another device;
    resolving the default touches no device."""
    import inspect

    import torch

    from grtpu_torch.digital import loops, modems
    from grtpu_torch.models import dmr
    from grtpu_torch.runtime.executor import StreamExecutor
    from grtpu_torch.utils import device

    assert device.resolve() == torch.device("cuda")
    assert device.resolve(None) == torch.device("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
    assert device.resolve(torch.device("cuda", 1)) == torch.device("cuda:1")
    from grtpu_torch.blocks import pfb as pfb_blocks
    from grtpu_torch.digital import ofdm
    from grtpu_torch.ops import dsp
    from grtpu_torch.runtime import top_block
    from grtpu_torch.utils import testing
    from grtpu_torch.fec import conv
    from grtpu_torch.models import atsc, atsc_rf, digital_voice
    from grtpu_torch.vocoder import cvsd, g72x, gsm

    for fn in (pfb_blocks.pfb_clock_sync_init,
               pfb_blocks.pfb_clock_sync_windowed_init, dsp.nco_sin,
               dsp.nco_cos, dsp.nco_exp, StreamExecutor.__init__,
               modems.GmskModem.__init__,
               modems.PskModem.__init__, modems.Fsk4Modem.__init__,
               dmr.DmrTransmitter.__init__, dmr.DmrReceiver.__init__,
               loops.costas_init_state, loops.mm_init_state,
               loops.mm_windowed_init_state, ofdm.OfdmModem.__init__,
               ofdm.ofdm_sync_fixed, top_block.TopBlock.__init__,
               testing.run_block, atsc.trellis_decode,
               conv.conv_encode_27_packed,
               atsc.AtscReceiver.__init__, atsc_rf.state_from_numpy,
               atsc_rf.fpll_init_state, atsc_rf.btl_init_state,
               atsc_rf.AtscEqualizerLms.__init__,
               atsc_rf.AtscEqualizerDfe.__init__,
               atsc_rf.AtscEqualizerNop.__init__,
               atsc_rf.AtscRfReceiver.__init__, g72x.g72x_init_state,
               cvsd.cvsd_init_state, gsm.gsm_init_encode_state,
               gsm.gsm_init_decode_state, digital_voice.DigitalVoiceTx.__init__,
               digital_voice.DigitalVoiceRx.__init__):
        assert inspect.signature(fn).parameters["device"].default is None, fn
    src = inspect.getsource(device)
    assert "is_available" not in src


def test_kernel_build_dir_is_ignored():
    """The kernel build cache lives in a directory git ignores."""
    from grtpu_torch.ops import _build

    rel = _build.BUILD_DIR.relative_to(REPO)
    assert rel.parts[0] == "build"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
