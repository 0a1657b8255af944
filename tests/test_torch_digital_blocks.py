"""The graph blocks of ``grtpu_torch.digital.blocks`` that wrap one op each
(CostasLoop, DiffEncoder, DiffDecoder, DiffPhasor, ConstellationDecoder),
held against grtpu's blocks on the CPU.

Each block runs as the executor runs it: ``init_state`` once, then
``apply`` over 4 chunks of 1,024 items with the state carried, on inputs
made with numpy from a local seed.  grtpu's ``apply`` runs under
``jax.jit``, compiled once a block (module-scoped fixture; the chunks share
one shape).  Bounds: CostasLoop and DiffPhasor samples and states to atol
1e-5 (the loop's phase compared modulo 2 pi); the decisions of
DiffEncoder, DiffDecoder and ConstellationDecoder, and their states, equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grtpu.digital import blocks as jdb  # noqa: E402
from grtpu.digital import constellation as jcon  # noqa: E402
from grtpu_torch.digital import blocks as tdb  # noqa: E402
from grtpu_torch.digital import constellation as tcon  # noqa: E402

CHUNK, CHUNKS = 1024, 4
N = CHUNK * CHUNKS


def qpsk_stream(rng, phase=0.4, freq=0.002, noise=0.05):
    """QPSK symbols turned by a phase and a frequency offset, with noise."""
    pts = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.randint(0, 4, N)))
    return (pts * np.exp(1j * (phase + freq * np.arange(N)))
            + noise * (rng.randn(N) + 1j * rng.randn(N))).astype(np.complex64)


def make_case(name):
    """(grtpu block, port block, input) of one block."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "CostasLoop":
        return jdb.CostasLoop(0.05, 4), tdb.CostasLoop(0.05, 4), \
            qpsk_stream(rng)
    if name in ("DiffEncoder", "DiffDecoder"):
        return getattr(jdb, name)(4), getattr(tdb, name)(4), \
            rng.randint(0, 4, N).astype(np.uint8)
    if name == "DiffPhasor":
        return jdb.DiffPhasor(), tdb.DiffPhasor(), \
            (rng.randn(N) + 1j * rng.randn(N)).astype(np.complex64)
    return (jdb.ConstellationDecoder(jcon.constellation_qpsk()),
            tdb.ConstellationDecoder(tcon.constellation_qpsk()),
            qpsk_stream(rng, freq=0.0, noise=0.3))


BLOCKS = ["CostasLoop", "DiffEncoder", "DiffDecoder", "DiffPhasor",
          "ConstellationDecoder"]


def run_chunks(apply, state, x, wrap):
    """apply over the chunks of x, the state carried; (outputs, state)."""
    ys = []
    for i in range(CHUNKS):
        state, y = apply(state, wrap(x[i * CHUNK:(i + 1) * CHUNK]))
        ys.append(np.asarray(y))
    return np.concatenate(ys), state


@pytest.fixture(scope="module")
def runs():
    """name -> (grtpu's outputs and state, the port's outputs and state)."""
    out = {}
    for name in BLOCKS:
        jblk, tblk, x = make_case(name)
        jy, jst = run_chunks(jax.jit(jblk.apply), jblk.init_state(), x,
                             jnp.asarray)
        ty, tst = run_chunks(tblk.apply, tblk.init_state(), x,
                             torch.from_numpy)
        out[name] = (jy, jax.tree_util.tree_leaves(jst), ty,
                     [s for s in (tst if isinstance(tst, tuple) else (tst,))])
    return out


def close(name):
    return name in ("CostasLoop", "DiffPhasor")


@pytest.mark.parametrize("name", BLOCKS)
def test_outputs_match_grtpu(runs, name):
    jy, _, ty, _ = runs[name]
    assert ty.shape == jy.shape == (N,) and ty.dtype == jy.dtype
    if close(name):
        np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("name", BLOCKS)
def test_carried_state_matches_grtpu(runs, name):
    _, jst, _, tst = runs[name]
    assert len(tst) == len(jst)
    for i, (t, j) in enumerate(zip(tst, jst)):
        t, j = t.numpy(), np.asarray(j)
        if name == "CostasLoop" and i == 0:
            d = (t - j + np.pi) % (2 * np.pi) - np.pi
            assert abs(d) < 1e-5
        elif close(name):
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
        else:
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
