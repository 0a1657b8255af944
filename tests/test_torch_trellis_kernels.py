"""The trellis / ATSC slice's two hand kernels, off the card.

* ``viterbi_route`` and ``viterbi_plan`` (pure): which route
  ``viterbi_fwd`` takes for an FSM's shape, and that each launch plan keeps
  a block within the 48 KB of shared memory it takes without an opt-in.
* ``dfe_feedback_fwd``'s transposed (scatter) recursion, modelled in numpy
  float32 in the kernel's own summation order (every output's terms in time
  order, the carried ring's first, each a fused multiply-add), held to the
  plain twin ``dfe_feedback_ref`` and to grtpu's scan: equal decisions and
  final ring, outputs within ``DFE_TOL``.  The card tests
  (``test_torch_cuda_trellis_atsc.py``) hold the kernel itself to the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtpu.models import atsc_rf as jr
from grtpu_torch.models import atsc, atsc_rf as rf
from grtpu_torch.ops import cuda_trellis as ct
from grtpu_torch.trellis import FSM

DFE_TOL = 1e-4
FSMS = {"fsm4": FSM.from_convolutional(1, 2, [[0b101, 0b111]]),
        "atsc": atsc.atsc_trellis_fsm(),
        "ccsds": FSM.from_convolutional(1, 2, [[0o117, 0o155]]),
        "isi256": FSM.from_isi(4, 5),
        "k5": FSM.from_convolutional(1, 2, [[0o23, 0o35]]),
        "k6": FSM.from_convolutional(1, 2, [[0o53, 0o75]])}


# ------------------------------------------------------------- Viterbi plan
@pytest.mark.parametrize("s,deg,o,route", [
    (4, 2, 4, "warp"),          # FSM4: 8 rows a warp
    (8, 4, 8, "warp"),          # ATSC: 4 rows a warp
    (1, 1, 2, "warp"),          # one state: 32 rows a warp
    (3, 2, 4, "warp"),          # S' = 4, one pad lane a row
    (32, 8, 4, "warp"),         # a whole warp a row, the largest in-degree
    (32, 2, 186, "warp"),       # the largest tile of one row in 48 KB
    (32, 2, 187, "block"),      # one more output symbol: no longer fits
    (33, 2, 4, "block"),        # more states than lanes
    (16, 9, 4, "block"),        # more edges than a lane's registers hold
    (64, 2, 4, "block"),        # CCSDS
    (256, 4, 1024, "block"),    # ISI 256
])
def test_viterbi_route(s, deg, o, route):
    assert ct.viterbi_route(s, deg, o) == route
    # an FSM with a missing edge takes the block route, whatever its size
    assert ct.viterbi_route(s, deg, o, complete=False) == "block"


@pytest.mark.parametrize("name", sorted(FSMS))
@pytest.mark.parametrize("b,t", [(1, 1), (13, 1000), (4096, 512),
                                 (12, 43056)])
def test_viterbi_plan_fits_a_block(name, b, t):
    fsm = FSMS[name]
    deg = fsm.PS.shape[1]
    auto = ct.viterbi_route(fsm.S, deg, fsm.O)
    assert auto == ("warp" if fsm.S <= 32 else "block")
    for route in {auto, "block"}:
        plan = ct.viterbi_plan(fsm.S, deg, fsm.O, b, t, route)
        assert plan.route == route
        assert 0 < plan.smem <= 48 * 1024
        if route == "warp":
            rows = 32 // (1 << (fsm.S - 1).bit_length())
            warps = -(-b // rows)         # one SM a warp, up to 132 warps
            assert plan.warps == min(4, -(-warps // 132))
        else:
            assert 1 <= plan.steps <= min(32, t)
            assert 1 <= plan.tb_steps <= t
    if auto == "block":
        with pytest.raises(ValueError, match="warp route"):
            ct.viterbi_plan(fsm.S, deg, fsm.O, b, t, "warp")


def test_tables_say_whether_an_edge_is_missing():
    assert all(ct.tables(f, "cpu").complete for f in FSMS.values())
    gappy = FSM(2, 2, 2, NS=[0, 1, 0, 0], OS=[0, 1, 0, 1])  # in-degrees 3, 1
    assert not ct.tables(gappy, "cpu").complete
    with pytest.raises(ValueError, match="warp route"):
        ct.viterbi_plan(2, gappy.PS.shape[1], 2, 1, 10, "warp", False)


def test_tables_must_say_whether_they_are_complete():
    """A table made by hand states ``complete``: a missing edge must never
    reach the warp route by a default."""
    t = ct.tables(FSMS["fsm4"], "cpu")
    with pytest.raises(TypeError):
        ct.TrellisTables(t.ps, t.pi, t.eo, t.O)


def test_viterbi_plan_spreads_warps_over_the_cards_sms():
    """The warp route gives each warp an SM while the card has one."""
    assert ct.viterbi_plan(4, 2, 4, 4096, 512, sms=132).warps == 4
    assert ct.viterbi_plan(4, 2, 4, 4096, 512, sms=512).warps == 1
    assert ct.viterbi_plan(4, 2, 4, 4096, 512, sms=256).warps == 2


def test_viterbi_plan_rejects_unknown_route():
    with pytest.raises(ValueError, match="no Viterbi route"):
        ct.viterbi_plan(4, 2, 4, 1, 10, "lane")


def test_viterbi_route_override_is_ignored_on_the_cpu():
    """A CPU tensor runs the twin whatever route is forced."""
    fsm = FSMS["atsc"]
    m = torch.from_numpy(np.random.RandomState(1).rand(5, 70, fsm.O)
                         .astype(np.float32))
    tab = ct.tables(fsm, "cpu")
    want = ct.viterbi_ref(m, tab)
    for route in ("warp", "block"):
        assert torch.equal(ct.viterbi_fwd(m, tab, _route=route), want)


# ------------------------------------------------- DFE scatter recursion
def fma32(a, b, c):
    """fmaf in numpy: the product of two float32 values is exact in
    float64; the sum is rounded to float64 and then to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def slicer32(y):
    """The kernel's slicer: 2 * clip(rint(fma(y, 0.5, 3.5)), 0, 7) - 7
    (y * 0.5 is exact, so the float32 sum rounds once, as the fma)."""
    v = np.float32(y) * np.float32(0.5) + np.float32(3.5)
    return np.float32(2.0) * np.clip(np.rint(v), np.float32(0),
                                     np.float32(7)) - np.float32(7)


def scatter_model(ff, wfb, ring):
    """dfe_feedback_fwd's recursion in numpy float32: slot q holds the
    partial sum of the pending output m = q (mod nfb).  The slots start
    from the ring's terms (i = nfb-1 down to m), then each step's decision
    d_k is added to every slot with weight wfb[m - k - 1], oldest term
    first; the owner's slot restarts for output k + nfb.  Returns (y, the
    final ring)."""
    ff, wfb, ring = (np.asarray(a, np.float32) for a in (ff, wfb, ring))
    n, nfb = len(ff), len(wfb)
    acc = np.zeros(nfb, np.float32)
    for i in range(nfb - 1, -1, -1):
        acc[:i + 1] = fma32(wfb[i], ring[i - np.arange(i + 1)], acc[:i + 1])
    w2 = np.concatenate([wfb, wfb])
    y = np.empty(n, np.float32)
    dec = np.empty(n, np.float32)
    for k in range(n):
        q = k % nfb
        y[k] = ff[k] - acc[q]
        dec[k] = slicer32(y[k])
        acc[q] = 0.0
        acc = fma32(w2[nfb - q - 1:2 * nfb - q - 1], dec[k], acc)
    ring_out = np.concatenate([dec[::-1], ring])[:nfb]
    return y, ring_out


def multipath_field(nfb=rf.DFE_NFB):
    """One field through 1 + 0.45 z^-60 + 0.2 z^-150 with noise 0.05, as the
    feedforward part passes it (its cursor tap 1), and the feedback taps
    that cancel the two echoes, dithered so that every tap counts."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 8, (312, 828)).astype(np.uint8)
    stream = rf.AtscFieldSyncMux()(data).astype(np.float32) * 2 - 7
    h = np.zeros(151, np.float32)
    h[0], h[60], h[150] = 1.0, 0.45, 0.2
    x = np.convolve(stream, h)[: len(stream)].astype(np.float32)
    x += 0.05 * rng.standard_normal(len(x)).astype(np.float32)
    wfb = (0.002 * rng.standard_normal(nfb)).astype(np.float32)
    wfb[59] += 0.45
    wfb[149] += 0.2
    return x, wfb, stream


def assert_against(y, ring_out, y_ref, ring_ref):
    y_ref = np.asarray(y_ref, np.float32)
    np.testing.assert_array_equal(slicer32(y), slicer32(y_ref))
    assert np.abs(y - y_ref).max() <= DFE_TOL
    np.testing.assert_array_equal(ring_out, np.asarray(ring_ref))


def test_scatter_model_against_twin_over_a_multipath_field():
    ff, wfb, stream = multipath_field()
    assert len(ff) == rf.SYMBOLS_PER_FIELD
    ring = np.zeros(len(wfb), np.float32)
    y, ring_out = scatter_model(ff, wfb, ring)
    y_ref, ring_ref = ct.dfe_feedback_ref(torch.from_numpy(ff),
                                          torch.from_numpy(wfb),
                                          torch.from_numpy(ring))
    assert_against(y, ring_out, y_ref.numpy(), ring_ref.numpy())
    # the taps cancel the echoes: the decisions are the symbols sent
    assert (slicer32(y) == stream).mean() > 0.999


@pytest.mark.parametrize("nfb", [32, 192, 256])
@pytest.mark.parametrize("n", [1, 100, 4097])
def test_scatter_model_against_twin(n, nfb):
    """Shapes the kernel must take: n below nfb (the final ring keeps part
    of the carried one), n = 1, n no multiple of 32."""
    r = np.random.RandomState(n + nfb)
    ff = (r.choice(np.arange(-7, 8, 2), n) + r.randn(n) * 0.3).astype(
        np.float32)
    wfb = (r.randn(nfb) * 0.02).astype(np.float32)
    ring = r.choice(np.arange(-7.0, 8.0, 2.0), nfb).astype(np.float32)
    y, ring_out = scatter_model(ff, wfb, ring)
    y_ref, ring_ref = ct.dfe_feedback_ref(torch.from_numpy(ff),
                                          torch.from_numpy(wfb),
                                          torch.from_numpy(ring))
    assert_against(y, ring_out, y_ref.numpy(), ring_ref.numpy())


def test_scatter_model_against_grtpu_scan():
    """grtpu's own feedback scan (``_dfe_filter`` with a feedforward part
    that passes its input) over the first 6,000 symbols of the field."""
    x, wfb, _ = multipath_field()
    n = 6000
    wff = np.zeros(rf.DFE_NFF, np.float32)
    wff[0] = 1.0
    x_ff = np.concatenate([x[:n], np.zeros(rf.DFE_NFF - 1, np.float32)])
    want = np.asarray(jr._dfe_filter(jnp.asarray(wff), jnp.asarray(wfb),
                                     jnp.asarray(x_ff),
                                     jnp.zeros(rf.DFE_NFB, jnp.float32)))
    y, _ = scatter_model(x[:n], wfb, np.zeros(rf.DFE_NFB, np.float32))
    np.testing.assert_array_equal(slicer32(y), slicer32(want))
    assert np.abs(y - want).max() <= DFE_TOL
