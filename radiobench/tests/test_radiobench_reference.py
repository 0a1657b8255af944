"""The plain references agree with the port at tiny sizes on the CPU, and
their designs with the port's (the references themselves import nothing of
the program)."""

import ast
import json

import numpy as np
import pytest
import torch

from radiobench import traffic
from radiobench.reference import designs
from radiobench.reference import dmr_4fsk48k as dmr_ref
from radiobench.reference import wbfm_rcv256 as wbfm_ref
from radiobench.tests.conftest import ROOT, TINY

WBFM = json.loads((ROOT / "radiobench/configs/wbfm_rcv256.json").read_text())
DMR = json.loads((ROOT / "radiobench/configs/dmr_4fsk48k.json").read_text())


@pytest.mark.parametrize("name", ["designs", "wbfm_rcv256", "dmr_4fsk48k",
                                  "precision"])
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "radiobench/reference" / f"{name}.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"grtpu_torch", "grtpu", "jax", "jaxlib", "flax"}


def test_designs_match_the_ports():
    from grtpu_torch.ops.mmse_interp import mmse_taps
    from grtpu_torch.utils import firdes

    for args in ((1.0, 2.048e6, 100e3, 50e3), (1.0, 256e3, 15e3, 1e3)):
        np.testing.assert_allclose(designs.low_pass(*args),
                                   firdes.low_pass(*args), atol=1e-7)
    np.testing.assert_allclose(designs.rrc(10, 10, 1.0, 0.2, 110),
                               firdes.root_raised_cosine(10, 10, 1.0, 0.2, 110),
                               atol=1e-6)
    np.testing.assert_allclose(designs.mmse_bank(), mmse_taps(), atol=1e-6)


def test_wbfm_reference_follows_the_port_across_requests():
    from grtpu_torch import StreamExecutor
    from radiobench.systems import wbfm_rcv256 as system

    mix = {**json.loads((ROOT / "radiobench/traffic/file.json").read_text()),
           **TINY["wbfm_rcv256.file"]["traffic"]}
    plan = traffic.Plan(mix, 3)
    src = system.sources(WBFM, mix, 3, "cpu")
    ex = StreamExecutor(system.graph(WBFM), chunk_size=mix["chunk"], device="cpu")
    outs = {}
    for r in range(4):
        s, at = plan.slot(r)
        outs[r] = ex.run(src[s, 0, at:at + mix["request_samples"]],
                         device_loop=True).numpy()
    nums = wbfm_ref.compare(WBFM, mix, src, plan, outs, 4)
    assert nums["bad_shape"] == 0 and nums["audio_err"] < 1e-5
    from grtpu_torch.blocks.filter import FirFilter

    taps = next(b for b in ex.order if isinstance(b, FirFilter)).taps
    assert len(taps) == len(wbfm_ref.audio_taps(WBFM)) == 617


def test_dmr_references_follow_the_port():
    from grtpu_torch import StreamExecutor
    from radiobench.systems import dmr_4fsk48k as system

    mix = {**json.loads((ROOT / "radiobench/traffic/stream.json").read_text()),
           **TINY["dmr_4fsk48k.stream"]["traffic"]}
    plan = traffic.Plan(mix, 4)
    src = system.sources(DMR, mix, 4, "cpu")
    ex = StreamExecutor(system.graph(DMR), chunk_size=mix["chunk"], device="cpu")
    outs = {}
    for r in range(3):
        s, at = plan.slot(r)
        d, v = ex.run(src[s, 0, at:at + mix["request_samples"]], device_loop=True)
        outs[r] = (d.numpy(), v.numpy())
    nums = dmr_ref.compare(DMR, mix, src, plan, outs, 3)
    assert nums == {**nums, "dibit_errors": 0, "dibit_count_gap": 0}
    assert nums["level_err_median"] < 1e-6


def test_tf32_rounds_to_ten_mantissa_bits():
    from radiobench.reference.precision import tf32

    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
