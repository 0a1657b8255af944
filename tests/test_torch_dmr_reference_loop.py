"""The DMR stream cell's reference M&M loop, compiled
(``radiobench/reference/mm_loop.c``), against its definition, the Python
loop ``radiobench.reference.dmr_4fsk48k.clock_recovery``.

The benchmark's check of ``dmr_4fsk48k.stream`` runs the compiled loop;
it must give the Python loop's levels bit for bit, in float64 (the
reference) and in float32 (the control), on ~20,000 symbols of the cell's
own signal, fed at once and in pieces, and at a stream end.  The loop is
built with the system C compiler (``cc``, ``gcc`` or ``clang``); the tests
skip only where none is found.  Neither the reference nor these tests
import the program or JAX.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from radiobench.reference import dmr_4fsk48k as dmr_ref  # noqa: E402
from radiobench.systems import dmr_4fsk48k as system  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "radiobench/configs/dmr_4fsk48k.json").read_text())
SEED = 2 ** 31 + 2626


@pytest.fixture(scope="module")
def matched():
    """The cell's signal through the float64 and float32 front ends."""
    if not any(shutil.which(cc) for cc in dmr_ref.COMPILERS):
        pytest.skip(f"no C compiler ({', '.join(dmr_ref.COMPILERS)}) to build "
                    f"{dmr_ref.MM_SOURCE.name}")
    x = system.sources(CFG, {"sources": 1, "source_samples": 200_000}, SEED,
                       "cpu")[0, 0]
    return {p: dmr_ref.Stream(CFG, p, "cpu").matched(x)
            for p in dmr_ref.PRECISIONS}


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_compiled_loop_is_the_python_loop(matched, precision):
    mf = matched[precision]
    want = dmr_ref.clock_recovery(CFG, mf, precision)
    assert len(want) > 19_000
    got = dmr_ref.Stream(CFG, precision, "cpu").recover(mf)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_compiled_loop_in_pieces(matched, precision):
    """Fed in 13 pieces of uneven length, the loop carries its state and
    samples across them and gives the same levels."""
    mf = matched[precision]
    want = dmr_ref.clock_recovery(CFG, mf, precision)
    walk = dmr_ref.Stream(CFG, precision, "cpu")
    cuts = np.sort(np.random.default_rng(26).integers(0, len(mf), 12))
    got = np.concatenate([walk.recover(p) for p in np.split(mf, cuts)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("end", [50_003, 50_007])
def test_compiled_loop_at_a_stream_end(matched, end):
    """A stream that ends mid-symbol: the loop stops where the Python loop
    breaks, and keeps a whole window of samples for the next piece."""
    mf = matched["float64"][:end]
    walk = dmr_ref.Stream(CFG, "float64", "cpu")
    assert np.array_equal(walk.recover(mf),
                          dmr_ref.clock_recovery(CFG, mf, "float64"))
    assert len(walk.tail) >= 8
