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
from radiobench.tests.conftest import ROOT, SEED, TINY

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


def _dmr_signal(n, seed):
    """(n,) complex64 of the cell's own signal (its sources' generator)."""
    from radiobench.systems import dmr_4fsk48k as system

    return system.sources(DMR, {"sources": 1, "source_samples": n}, seed, "cpu")[0, 0]


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_compiled_loop_is_the_python_loop(precision):
    """``mm_loop.c`` gives ``clock_recovery``'s levels bit for bit: over
    100,001 symbols of the cell's signal, fed at once and in pieces, and at
    each of ten stream ends, all of which the loop's break decides (the
    last window still fits, its step would not)."""
    mf = dmr_ref.Stream(DMR, precision, "cpu").matched(_dmr_signal(1_000_000, SEED))
    want = dmr_ref.clock_recovery(DMR, mf, precision)
    assert len(want) > 100_000
    assert np.array_equal(dmr_ref.Stream(DMR, precision, "cpu").recover(mf), want)
    walk = dmr_ref.Stream(DMR, precision, "cpu")
    cuts = np.sort(np.random.default_rng(5).integers(0, len(mf), 40))
    got = [walk.recover(p) for p in np.split(mf, cuts)]
    assert np.array_equal(np.concatenate(got), want)
    for end in range(20_000, 19_990, -1):
        walk = dmr_ref.Stream(DMR, precision, "cpu")
        got = walk.recover(mf[:end])
        assert np.array_equal(got, dmr_ref.clock_recovery(DMR, mf[:end], precision))
        assert len(walk.tail) >= 8


@pytest.mark.parametrize("per", [1, 2, 7])
def test_piecewise_walk_is_the_whole_stream(per, monkeypatch):
    from radiobench.systems import dmr_4fsk48k as system

    mix = {**json.loads((ROOT / "radiobench/traffic/stream.json").read_text()),
           **TINY["dmr_4fsk48k.stream"]["traffic"]}
    plan = traffic.Plan(mix, SEED)
    src = system.sources(DMR, mix, SEED, "cpu")
    n = 14     # more requests than the tiny source holds: the stream wraps
    whole = np.concatenate(list(dmr_ref.stream_pieces(DMR, mix, src, plan, n)))
    monkeypatch.setattr(dmr_ref, "PIECE_SAMPLES", per * mix["request_samples"])
    pieces = list(dmr_ref.stream_pieces(DMR, mix, src, plan, n))
    assert len(pieces) == -(-n // per)
    got = np.concatenate(pieces)
    assert len(got) == len(whole) > 14 * 1700
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-12)


def _python_levels(mix, src, plan, n, precision):
    """The check's levels as they were before the loop was compiled: the
    whole stream through the matched filter at once, then the Python loop."""
    x = dmr_ref._stream_input(mix, src, plan, 0, n)
    mf = dmr_ref.Stream(DMR, precision, "cpu").matched(x)
    return dmr_ref.clock_recovery(DMR, mf, precision)


def _python_compare(want, outputs, n):
    """``compare``'s numbers as they were worked out before: on the whole
    arrays at once."""
    got_d = np.concatenate([np.asarray(outputs[r][0]).reshape(-1) for r in range(n)])
    got_v = np.concatenate([np.asarray(outputs[r][1]).reshape(-1) for r in range(n)])
    m = min(len(got_d), len(got_v), len(want))
    clear = np.min(np.abs(want[:m, None] - np.array(dmr_ref.THRESHOLDS)),
                   axis=-1) > dmr_ref.CLEAR
    errors = int(((got_d[:m] != dmr_ref.slice4(want[:m])) & clear).sum())
    short = len(want) - len(got_d)
    gap = max(0, short - 2) if short >= 0 else -short
    return {"dibit_errors": errors,
            "dibit_count_gap": gap + abs(len(got_v) - len(got_d)),
            "level_err_median": float(np.median(np.abs(got_v[:m] - want[:m])))}


@pytest.mark.parametrize("one_request_pieces", [False, True])
def test_compare_and_control_give_the_python_paths_numbers(one_request_pieces,
                                                            monkeypatch):
    from grtpu_torch import StreamExecutor
    from radiobench.systems import dmr_4fsk48k as system

    mix = {**json.loads((ROOT / "radiobench/traffic/stream.json").read_text()),
           **TINY["dmr_4fsk48k.stream"]["traffic"]}
    plan = traffic.Plan(mix, SEED)
    src = system.sources(DMR, mix, SEED, "cpu")
    ex = StreamExecutor(system.graph(DMR), chunk_size=mix["chunk"], device="cpu")
    n = 4
    outs = {}
    for r in range(n):
        s, at = plan.slot(r)
        d, v = ex.run(src[s, 0, at:at + mix["request_samples"]], device_loop=True)
        outs[r] = (d.numpy(), v.numpy())
    want = _python_compare(_python_levels(mix, src, plan, n, "float64"), outs, n)
    control = dmr_ref.control(DMR, mix, src, plan, list(range(n)), n)
    old_v = _python_levels(mix, src, plan, n, "tf32")
    if one_request_pieces:
        monkeypatch.setattr(dmr_ref, "PIECE_SAMPLES", mix["request_samples"])
    got = dmr_ref.compare(DMR, mix, src, plan, outs, n)
    assert got == {**want, "level_err_median": got["level_err_median"]}
    assert abs(got["level_err_median"] - want["level_err_median"]) <= 1e-12
    assert got["level_err_median"] == want["level_err_median"] or one_request_pieces
    if not one_request_pieces:
        assert np.array_equal(control[0][1], old_v)
        assert np.array_equal(control[0][0], dmr_ref.slice4(old_v))
        old = {0: (dmr_ref.slice4(old_v), old_v), **{r: control[r] for r in range(1, n)}}
        assert (dmr_ref.compare(DMR, mix, src, plan, control, n)
                == _python_compare(_python_levels(mix, src, plan, n, "float64"), old, n))


def test_no_c_compiler_fails_the_check_by_name(tmp_path, monkeypatch):
    monkeypatch.setattr(dmr_ref, "BUILD", tmp_path)
    monkeypatch.setattr(dmr_ref.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler found"):
        dmr_ref.Stream(DMR, "float64", "cpu")


def test_slice4_is_the_nested_thresholds():
    v = np.concatenate([np.random.default_rng(2).normal(0, 0.8, 10_000),
                        [2 / 3, 0.0, -0.0, -2 / 3, 1 / 3, -1.0, np.inf, -np.inf, np.nan]])
    nested = np.where(v > 2 / 3, 1, np.where(v > 0, 0, np.where(v > -2 / 3, 2, 3)))
    got = dmr_ref.slice4(v)
    assert got.dtype == np.uint8 and np.array_equal(got, nested)
