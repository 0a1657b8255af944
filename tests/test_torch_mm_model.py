"""The exact M&M clock recovery's two forms on the CPU: the plain loop, and
a model of the ``mm_fwd`` kernel's walk.

``clock_recovery_mm_ff`` and ``clock_recovery_mm_cc`` route a CUDA tensor
to the ``mm_fwd`` kernel (``grtpu_torch.ops.cuda_mm``) and run the plain
loop ``loops._mm_exact`` on a CPU tensor; the wrapper refuses what the
kernel does not take before it reaches the card.

The kernel cannot run here, so ``kernel_model`` below repeats its walk in
NumPy scalars, operation for operation: the window clamped as torch clamps
it (and wrapped below 8 samples, as a negative gather index wraps), the
phase ``rint(128 mu)``, the dot speculated with fused multiply-adds
(``_mm_cases.fma32``, exact rounding), the error, its clip in cc mode,
omega's clamp, the update, the stop at the first invalid slot and its
sample repeated in the slots after it; every ``seg`` symbols and where the
walk stops, the check of each recorded symbol against the plain loop's sum
(each product exact in float64, one float64 and one float32 rounding a
term; the real part of a complex window rounding its products first) and
the walk taken back to the first symbol speculated wrong; and the tiles:
the samples staged ``tile`` at a time, the walk stopped where a window
leaves them and the tile staged again from ``BACK`` samples before that
window.  It is held to the plain loop bit for bit (``torch.equal`` on ys,
n_valid and the four state tensors) on real and complex streams, with omega
pinned at each limit, a stream end that freezes the state, chunks carried
through ``rebase_mm_state``, tiles far smaller than the stream (restaged
many times), 4 to 9 samples, and symbols the speculation gets wrong
(``_mm_cases.engineered``) at the start, inside a check's segment, in a
later one and in a restaged tile.  The card tests
(``tests/test_torch_cuda_mm.py``) hold the kernel itself to the plain loop
run on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _mm_cases as mc  # noqa: E402
from grtpu_torch.digital import loops  # noqa: E402
from grtpu_torch.ops import cuda_fir, cuda_mm  # noqa: E402
from grtpu_torch.ops.mmse_interp import mmse_taps  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "grtpu_torch" / "csrc"
          / "mm_clock.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BACK = _constant("kBack")
MIN_TILE = _constant("kMinTile")
SEG = _constant("kSeg")
f32 = np.float32
levels = mc.levels


def _slc(v):
    return f32(1.0) if v > 0 else f32(-1.0)


def _clamp(v, lo, hi):
    return v if np.isnan(v) else min(max(v, lo), hi)


def _ordered(w, t):
    acc = f32(w[0] * t[0])
    for k in range(1, 8):
        acc = f32(acc + f32(w[k] * t[k]))
    return acc


def _interpolate(w, t, cc, exact):
    """(sr, si): the plain loop's sums, or the speculated ones (fused
    multiply-adds where it sums in float64)."""
    dot = mc.fused_route if exact else mc.fma_route
    if cc:
        return _ordered([v.real for v in w], t), dot([v.imag for v in w], t)
    return dot(w, t), f32(0)


def _update(st, samp, cc, q):
    """The step from state st and its sample: (next state, valid)."""
    mu, omega, base, last = st
    g_om, g_mu, lo, hi, nf = q
    if cc:
        sr, si = f32(samp.real), f32(samp.imag)
        a = f32(f32(_slc(last.real) * sr) + f32(_slc(last.imag) * si))
        b = f32(f32(_slc(sr) * last.real) + f32(_slc(si) * last.imag))
        err = _clamp(f32(a - b), f32(-1), f32(1))
    else:
        err = f32(f32(_slc(last) * samp) - f32(_slc(samp) * last))
    om2 = _clamp(f32(omega + f32(g_om * err)), lo, hi)
    step = f32(f32(mu + om2) + f32(g_mu * err))
    fl = np.floor(step)
    nb = f32(base + fl)
    return (f32(step - fl), om2, nb, samp), bool(f32(nb + f32(8)) <= nf)


def _bits(v):
    return np.asarray(v).reshape(1).view(np.uint32)


def _same_state(a, b):
    return all(np.array_equal(_bits(u), _bits(v)) for u, v in zip(a, b))


def kernel_model(x, state, omega_nominal, gain_omega, gain_mu, limit, cc,
                 tile, seg=SEG):
    """csrc/mm_clock.cu's mm_kernel on x (n_in,) float32 or complex64
    (numpy) from state (mu, omega, base, last) numpy scalars, staging
    ``tile`` samples at a time and checking every ``seg`` symbols.  The
    walker's other speculations (floors without the conversion unit, no
    NaN handling) are exact in the ranges these inputs reach, so it runs
    the exact update; the check holds each recorded symbol's sample and
    successor to the exact forms, as the kernel's does.  Returns (ys,
    n_valid, state, restages, redone): redone counts the symbols the check
    found speculated wrong."""
    n_in = len(x)
    max_out = cuda_mm.max_out_for(n_in, omega_nominal, limit)
    om_lim = omega_nominal * limit
    q = (f32(gain_omega), f32(gain_mu), f32(omega_nominal - om_lim),
         f32(omega_nominal + om_lim), f32(n_in))
    bank = mmse_taps()
    ys = np.empty(max_out, x.dtype)
    max_t0 = max(n_in - tile, 0)

    def start(base):
        return min(max(int(np.floor(base)), 0), n_in - 8)

    def inputs(staged, t0, t1, st):
        """(taps, window, s, out) of the symbol from state st."""
        t = bank[min(max(int(np.rint(st[0] * f32(128))), 0), 128)]
        s = start(st[2])
        out = n_in >= 8 and (s < t0 or s + 8 > t1)
        w = None if out else [staged[(g + n_in if g < 0 else g) - t0]
                              for g in range(s, s + 8)]
        return t, w, s, out

    def sample(t, w, exact):
        sr, si = _interpolate(w, t, cc, exact)
        return np.complex64(complex(sr, si)) if cc else sr

    st, slot = tuple(state), 0
    t0 = min(max(start(st[2]) - BACK, 0), max_t0)
    stage, exact_first, restages, redone = True, False, 0, 0
    while True:
        if stage:
            staged = x[t0:t0 + tile].copy()    # the tile in shared memory
            t1 = t0 + len(staged)
        # the walk: at most seg symbols, each recorded with its state
        hist, why, exact, seg0 = [], "done", exact_first, slot
        while slot < max_out:
            if len(hist) == seg:
                why = "check"
                break
            t, w, s, out = inputs(staged, t0, t1, st)
            if out:
                why = "restage"
                break
            samp = sample(t, w, exact)
            exact = False
            hist.append((st, samp))
            ys[slot] = samp
            nxt, valid = _update(st, samp, cc, q)
            if not valid:
                why = "frozen"
                break
            st = nxt
            slot += 1
        # the check: each recorded symbol made again exactly from its state
        bad = None
        for j, (h, samp) in enumerate(hist):
            t, w, _, out = inputs(staged, t0, t1, h)
            ok = not out and np.array_equal(_bits(samp),
                                            _bits(sample(t, w, True)))
            if ok:
                nxt, valid = _update(h, samp, cc, q)
                if j == len(hist) - 1 and why == "frozen":
                    ok = not valid
                else:
                    after = hist[j + 1][0] if j + 1 < len(hist) else st
                    ok = valid and _same_state(nxt, after)
            if not ok:
                bad = j
                break
        exact_first, stage = bad is not None, False
        if exact_first:
            redone += 1
            st, slot = hist[bad][0], seg0 + bad
        elif why == "restage":
            restages += 1
            t0, stage = min(max(s - BACK, 0), max_t0), True
        elif why in ("done", "frozen"):
            break
    if why == "frozen":
        ys[slot + 1:] = hist[-1][1]
    return ys, slot, st, restages, redone


def numpy_state(st):
    return tuple(t.numpy()[()] for t in st)


def assert_same(got, want):
    """The model's (ys, n_valid, state) against the plain loop's, bit for
    bit."""
    ys, nv, st = got
    assert torch.equal(torch.from_numpy(ys), want[0])
    assert nv == int(want[1]) and want[1].dtype == torch.int32
    for g, w in zip(st, want[2]):
        assert torch.equal(torch.tensor(g), w)


def run_both(x, state, args, cc, tile=None, seg=SEG):
    """The model at ``tile`` (all samples staged by default) and ``seg``,
    and the plain loop, on the CPU; asserts they agree and returns (plain
    result, restages, redone)."""
    fn = loops.clock_recovery_mm_cc if cc else loops.clock_recovery_mm_ff
    want = fn(torch.from_numpy(x), state, *args)
    got = kernel_model(x, numpy_state(state), *args, cc,
                       tile or max(len(x), 1), seg)
    assert_same(got[:3], want)
    return want, got[3], got[4]


DMR = (10.0, 0.25 * 0.05 ** 2, 0.05, 0.005)     # the stream cell's loop


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("n", [4, 5, 7, 8, 9, 31, 437, 4340])
def test_model_is_the_plain_loop(cc, n):
    x = levels(n, DMR[0], n, cplx=cc)
    state = loops.mm_init_state(DMR[0], 0.5, complex_mode=cc, device="cpu")
    run_both(x, state, DMR, cc)


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("tile", [256, 300, 1000])
def test_model_restages_tiles(cc, tile):
    """A stream many tiles long: the walk stops at each tile's end, the
    block stages the next, and nothing changes in the outputs."""
    x = levels(6000, 4.0, 7, cplx=cc)
    state = loops.mm_init_state(4.0, 0.3, complex_mode=cc, device="cpu")
    _, restages, _ = run_both(x, state, (4.0, 0.25 * 0.175 ** 2, 0.175, 0.005),
                              cc, tile, seg=100)
    assert restages >= (6000 - tile) // tile


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("side", [-1.0, 1.0])
def test_model_pins_omega_at_each_limit(cc, side):
    """A large omega gain and an error of one sign a symbol (a stream of one
    level, offset): omega sits at lo or hi from the first symbols on."""
    x = levels(2000, 8.0, 3, cplx=cc, offset=3.0 * side)
    state = loops.mm_init_state(8.0, 0.5, complex_mode=cc, device="cpu")
    args = (8.0, 2.0, 0.1, 0.01)
    want, _, _ = run_both(x, state, args, cc, tile=MIN_TILE)
    omega = float(want[2].omega)
    assert omega in (float(f32(8.0 * 0.99)), float(f32(8.0 * 1.01)))


@pytest.mark.parametrize("cc", [False, True])
def test_model_freezes_at_the_stream_end(cc):
    """The last slots are invalid: n_valid stops short of max_out, the
    state keeps the last valid step and every later slot repeats the first
    invalid one's sample."""
    x = levels(203, 3.0, 11, cplx=cc)
    state = loops.mm_init_state(3.0, 0.9, complex_mode=cc, device="cpu")
    args = (3.0, 0.01, 0.2, 0.05)
    want, _, _ = run_both(x, state, args, cc, seg=7)
    nv, ys = int(want[1]), want[0]
    assert nv < len(ys) - 2
    assert torch.equal(ys[nv:], ys[nv].expand(len(ys) - nv))


@pytest.mark.parametrize("cc", [False, True])
def test_model_carries_chunks(cc):
    """Chunk after chunk, the state carried through rebase_mm_state with
    the block's history kept, as ClockRecoveryMM{FF,CC} runs: each chunk's
    model and plain loop agree from the same carried state."""
    omega, hist, chunk = 10.0, 8 + 10 + 3, 431
    x = levels(24 * chunk + hist, omega, 5, cplx=cc)
    state = loops.mm_init_state(omega, 0.5, complex_mode=cc, device="cpu")
    total = 0
    for c in range(24):
        seg = x[c * chunk:c * chunk + chunk + hist - 1]
        want, _, _ = run_both(seg, state, DMR, cc, tile=MIN_TILE)
        total += int(want[1])
        state = loops.rebase_mm_state(want[2], chunk)
    assert total > 0.9 * 24 * chunk / omega


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("j,seg,tile", [(0, SEG, None), (3, 5, None),
                                        (7, 5, None), (12, 5, 256)])
def test_model_redoes_a_speculated_symbol(cc, j, seg, tile):
    """A symbol whose fused multiply-adds round off the plain loop's sum
    (the first, one inside a segment, one in a later segment, one in a
    restaged tile): the check finds it, the walk goes back and makes it
    exactly, and the outputs are the plain loop's."""
    x, w = mc.engineered(10 * j + 300, [j], cplx=cc)
    state = loops.mm_init_state(10.0, 0.5, complex_mode=cc, device="cpu")
    want, _, redone = run_both(x, state, DMR, cc, tile, seg)
    taps = mmse_taps()[64]
    got = want[0][j].imag if cc else want[0][j]
    assert float(got) == mc.fused_route(w, taps) != mc.fma_route(w, taps)
    assert redone >= 1


@pytest.mark.parametrize("cc", [False, True])
@pytest.mark.parametrize("base", [-37.0, 3.5, 1e9])
def test_model_from_states_off_the_stream(cc, base):
    """A window pointer below the stream, between samples or past its end."""
    x = levels(600, 10.0, 21, cplx=cc)
    state = loops.mm_init_state(10.0, 0.5, complex_mode=cc, device="cpu")
    run_both(x, state._replace(base=torch.tensor(base)), DMR, cc, seg=50)


def test_cpu_tensors_run_the_plain_loop(monkeypatch):
    """A CPU tensor never reaches the wrapper and launches nothing."""
    def refuse(*a, **k):
        raise AssertionError("mm_fwd called for a CPU tensor")

    monkeypatch.setattr(cuda_mm, "mm_fwd", refuse)
    before = dict(cuda_fir.launches)
    for cc in (False, True):
        x = torch.from_numpy(levels(500, 10.0, 2, cplx=cc))
        state = loops.mm_init_state(10.0, 0.5, complex_mode=cc, device="cpu")
        fn = loops.clock_recovery_mm_cc if cc else loops.clock_recovery_mm_ff
        got = fn(x, state, *DMR)
        want = loops._mm_exact(x, state, *DMR, clip_err=cc)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            assert torch.equal(g, w)
    assert cuda_fir.launches == before


def _state(cc, **kw):
    st = loops.mm_init_state(10.0, 0.5, complex_mode=cc, device="cpu")
    return st._replace(**kw)


@pytest.mark.parametrize("x,state,cc,exc,match", [
    (torch.zeros(64, dtype=torch.float64), _state(False), False, TypeError,
     "float32 or complex64"),
    (torch.zeros(2, 64), _state(False), False, ValueError, "one stream"),
    (torch.zeros(64, dtype=torch.complex64), _state(True), False, TypeError,
     "mm_ff"),
    (torch.zeros(64), _state(False), True, TypeError, "mm_cc"),
    (torch.zeros(64), _state(False, mu=torch.zeros((), dtype=torch.float64)),
     False, TypeError, "mu"),
    (torch.zeros(64), _state(False, base=torch.zeros(2)), False, TypeError,
     "base"),
    (torch.zeros(64), _state(True), False, TypeError, "last"),
    (torch.zeros(3), _state(False), False, ValueError, "4 samples"),
    (torch.zeros(64), _state(False), False, ValueError, "CUDA"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(x, state, cc, exc,
                                                       match):
    with pytest.raises(exc, match=match):
        cuda_mm.mm_fwd(x, *state, *DMR, cc)


def test_plain_loop_refuses_three_samples():
    """Below 4 samples the window's indices leave the stream in the plain
    loop too, so the wrapper refuses no length the plain loop takes."""
    state = loops.mm_init_state(10.0, 0.5, device="cpu")
    with pytest.raises(IndexError):
        loops.clock_recovery_mm_ff(torch.zeros(3), state, *DMR)


@pytest.mark.parametrize("cc", [False, True])
def test_max_tile_fits_the_source(cc):
    """``max_tile`` is the largest tile whose bank and samples fit the
    shared memory that mm_clock.cu's entry allows."""
    optin, reserve = _constant("kSmemOptin"), _constant("kStaticReserve")
    fixed = (_constant("kPhases") * _constant("kTaps")
             + (_constant("kSeg") + 1) * _constant("kHist"))
    c = 2 if cc else 1
    tile = cuda_mm.max_tile(cc)

    def fits(t):
        return (fixed + t * c) * 4 <= optin - reserve

    assert fits(tile) and not fits(tile + 1) and tile >= MIN_TILE
    assert cuda_mm.MIN_SAMPLES == _constant("kTaps") // 2
