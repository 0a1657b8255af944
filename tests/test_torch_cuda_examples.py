"""grtpu_torch.examples on the card, against the same example on the CPU.

trellis_ber's tcm and eq sweeps give the CPU's error counts and reach the
hand kernel ``viterbi_fwd``; the how-to tag block emits the QA offsets under
``run(device_loop=True)``; wfm_demod's audio is within 1e-5 of the CPU's.
Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.  The
file imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_examples.py -m cuda --noconftest
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch.examples import (  # noqa: E402
    howto_write_a_block as howto, trellis_ber, wfm_demod)
from grtpu_torch.ops import cuda_fir  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("esn0", [2.0, 5.0])
@pytest.mark.parametrize("scheme", ["tcm", "eq"])
def test_trellis_sweep_on_the_card(dev, scheme, esn0):
    args = [scheme, "-e", str(esn0), "-K", "256", "-r", "8"]
    cpu = printed(trellis_ber.main, args + ["--device", "cpu"])
    before = cuda_fir.launches["viterbi_fwd"]
    card = printed(trellis_ber.main, args)
    assert cuda_fir.launches["viterbi_fwd"] - before == 1
    assert card == cpu


@pytest.mark.parametrize("scheme", ["sccc", "pccc", "turbo-eq"])
def test_turbo_sweep_on_the_card(dev, scheme):
    args = [scheme, "-e", "2", "-K", "128", "-r", "2", "-i", "3"]
    assert printed(trellis_ber.main, args) == \
        printed(trellis_ber.main, args + ["--device", "cpu"])


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["step", "device_loop"])
def test_threshold_tags_on_the_card(dev, device_loop):
    from grtpu_torch import Graph, Port, StreamExecutor
    from grtpu_torch.blocks.gengen import VectorSink

    src = np.array([0, 2, 0, 0, 3, 3, 0, 2] * 4, np.float32)
    g = Graph()
    pin = g.add_input(Port(torch.float32))
    s = VectorSink(dtype=torch.float32)
    g.connect(pin, howto.ThresholdTagFF(1.0), s)
    above = src > 1
    rising = np.flatnonzero(above & ~np.concatenate([[False], above[:-1]]))
    assert list(rising[:3]) == [1, 4, 7]        # qa_threshold_tag_ff's
    ex = StreamExecutor(g, chunk_size=4, device=dev)
    for r in range(2):     # the second device_loop run replays graphs; the
        ex.sink_tags.clear()             # stream's offsets go on from 32
        ex.run(src, device_loop=device_loop)
        offs = sorted(t.offset for t in ex.sink_tags[s.name])
        assert offs == list(rising + r * len(src))
        np.testing.assert_array_equal(s.data(), src)


def test_howto_main_on_the_card(dev):
    lines = printed(howto.main, [])
    assert [line.split(":")[0] for line in lines] == [
        "qa_square_ff", "qa_square_accum_ff", "qa_threshold_tag_ff"]


def test_wfm_demod_card_matches_cpu(dev, tmp_path, monkeypatch):
    t = np.arange(1 << 18) / 256e3
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    cap = tmp_path / "fm.cfile"
    np.exp(1j * np.cumsum(2 * np.pi * 75e3 / 256e3 * msg)).astype(
        np.complex64).tofile(cap)
    audio = {}
    real = wfm_demod.save_wav

    def keep(path, rate, data):
        audio[path] = np.asarray(data)
        real(path, rate, data)

    monkeypatch.setattr(wfm_demod, "save_wav", keep)
    for name, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        wfm_demod.main([str(cap), str(tmp_path / f"{name}.wav")] + extra)
    card, cpu = audio[str(tmp_path / "card.wav")], audio[str(tmp_path / "cpu.wav")]
    assert card.shape == cpu.shape == (1 << 15,)
    np.testing.assert_allclose(card, cpu, atol=1e-5, rtol=0)
