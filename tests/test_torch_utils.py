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

from grtpu.utils import firdes as jf  # noqa: E402
from grtpu.runtime import tags as jtags  # noqa: E402
from grtpu_torch.utils import firdes as tf  # noqa: E402
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


def test_tags_identical():
    tags = [jtags.Tag(10, "a", 1), jtags.Tag(25, "b", 2), jtags.Tag(3, "c")]
    ttag = [ttags.Tag(t.offset, t.key, t.value, t.srcid) for t in tags]
    for rate in (1.0, 0.125, 4.0):
        assert ([tuple(vars(t).values()) for t in jtags.propagate_tags(tags, rate)]
                == [tuple(vars(t).values())
                    for t in ttags.propagate_tags(ttag, rate)])
    assert ([t.offset for t in jtags.tags_in_window(tags, 3, 25)]
            == [t.offset for t in ttags.tags_in_window(ttag, 3, 25)])


def test_import_pulls_in_no_jax():
    """Packaging guard: the port imports neither jax nor grtpu."""
    code = ("import sys, grtpu_torch, grtpu_torch.blocks.analog, "
            "grtpu_torch.blocks.filter, grtpu_torch.blocks.gengen, "
            "grtpu_torch.models.fm, grtpu_torch.models.dmr, "
            "grtpu_torch.ops.cuda_fir, grtpu_torch.ops.fft_filter, "
            "grtpu_torch.ops.mmse_interp, grtpu_torch.digital.blocks, "
            "grtpu_torch.digital.constellation, grtpu_torch.digital.loops, "
            "grtpu_torch.digital.modems; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'grtpu' "
            "or m.startswith('grtpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
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
    for fn in (StreamExecutor.__init__, modems.GmskModem.__init__,
               modems.PskModem.__init__, modems.Fsk4Modem.__init__,
               dmr.DmrTransmitter.__init__, dmr.DmrReceiver.__init__,
               loops.costas_init_state, loops.mm_init_state,
               loops.mm_windowed_init_state):
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
