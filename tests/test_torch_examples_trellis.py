"""grtpu_torch.examples.trellis_ber held against grtpu's examples/trellis_ber.py.

Each case runs grtpu's example in-process on the CPU (its ``main`` under a
patched ``sys.argv``) and the port's ``main([..., "--device", "cpu"])`` with
the same arguments, and compares the printed lines: the error counts are
**equal** (the data and noise are drawn from the same ``default_rng`` calls in
the same order, and the port's turbo decoders are array-equal to grtpu's,
tests/test_torch_trellis.py).  Small sizes: K=64 steps, 4 packets, 3 turbo
iterations, at two Es/N0 each; at 2 dB every scheme makes errors (asserted),
so the comparison is not of two zeros.
"""

import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from grtpu_torch.examples import trellis_ber as tber  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCHEMES = ["tcm", "eq", "sccc", "pccc", "turbo-eq"]
ESN0 = [2.0, 5.0]
NONZERO_AT = 2.0      # the Es/N0 at which every scheme here counts errors
SMALL = ["-K", "64", "-r", "4", "-i", "3"]


def grtpu_example(name):
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module(f"examples.{name}")


def run_grtpu(monkeypatch, capsys, name, args):
    mod = grtpu_example(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def run_port(capsys, module, args):
    capsys.readouterr()
    module.main(args + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def errors_of(line):
    return int(line.split("symbols")[1].split("errors")[0])


@pytest.mark.parametrize("esn0", ESN0)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_trellis_ber_counts_equal(monkeypatch, capsys, scheme, esn0):
    args = [scheme, "-e", str(esn0)] + SMALL
    ref = run_grtpu(monkeypatch, capsys, "trellis_ber", args)
    got = run_port(capsys, tber, args)
    assert got == ref and len(got) == 1
    assert f"{64 * 4} symbols" in got[0]
    if esn0 == NONZERO_AT:
        assert errors_of(got[0]) > 0, got


@pytest.mark.parametrize("scheme,O", [("tcm", 4), ("eq", 64)])
def test_viterbi_sweeps_are_one_batched_call(monkeypatch, scheme, O):
    """tcm and eq hand their whole sweep to cuda_trellis.viterbi_fwd (the
    hand kernel on the card, its twin here) as one (rep, K, O) batch."""
    from grtpu_torch.ops import cuda_trellis

    calls = []
    real = cuda_trellis.viterbi_fwd

    def spy(metrics, *a, **k):
        calls.append(tuple(metrics.shape))
        return real(metrics, *a, **k)

    monkeypatch.setattr(cuda_trellis, "viterbi_fwd", spy)
    sim = {"tcm": tber.sim_tcm, "eq": tber.sim_eq}[scheme]
    errs, total = sim(2.0, 64, 4, 0, device="cpu")
    assert calls == [(4, 64, O)] and total == 256 and errs > 0
