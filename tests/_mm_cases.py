"""Inputs for the M&M clock recovery tests (tests/test_torch_mm_model.py on
the CPU, tests/test_torch_cuda_mm.py on the card).

``levels`` makes a symbol stream; ``engineered`` a silent stream whose
chosen symbols the speculation gets wrong; ``fma32`` rounds x * t + acc once to
float32, as a fused multiply-add does, in exact arithmetic; ``engineer``
makes an 8-sample window whose interpolated sample the fused multiply-adds
get wrong: its float64 running sum lands on a float32 midpoint that the
exact sum misses, so that the plain loop's rounding (float64, then float32)
and one rounding of the exact sum part.  ``mm_fwd`` speculates with fused
multiply-adds and must check and redo such a symbol.
"""

from fractions import Fraction

import numpy as np

f32 = np.float32


def levels(n, sps, seed, cplx=False, offset=0.0):
    """A 4-level (or QPSK) symbol stream at sps samples a symbol, each
    symbol ramped into the next, with noise and a constant offset; numpy."""
    r = np.random.RandomState(seed)
    nsym = -(-n // int(sps)) + 2
    sym = r.choice([-1.0, -1 / 3, 1 / 3, 1.0], nsym)
    if cplx:
        sym = sym + 1j * r.choice([-1.0, 1.0], nsym)
    pos = np.arange(n) / sps
    k = np.minimum(pos.astype(int), nsym - 2)
    frac = pos - k
    v = (1 - frac) * sym[k] + frac * sym[k + 1] + offset
    v = v + 0.05 * r.randn(n) + (0.05j * r.randn(n) if cplx else 0)
    return v.astype(np.complex64 if cplx else np.float32)


def fma32(x, t, acc):
    """float32 x * t + acc rounded once, to nearest even (finite normal
    results; a zero keeps IEEE's sign rule)."""
    x, t, acc = f32(x), f32(t), f32(acc)
    s = float(x) * float(t) + float(acc)        # the float64 sum
    bits = int(np.float64(s).view(np.uint64))
    if s != 0 and abs(s) >= 2.0 ** -126 and bits & ((1 << 29) - 1) != 1 << 28:
        return f32(s)        # not a float32 midpoint: one rounding or two agree
    q = Fraction(float(x)) * Fraction(float(t)) + Fraction(float(acc))
    if q == 0:
        both_neg = (x * t == 0 and np.signbit(x) != np.signbit(t)
                    and np.signbit(acc))
        return f32(-0.0) if both_neg else f32(0.0)
    f = f32(float(q))
    near = (f, np.nextafter(f, f32(np.inf)), np.nextafter(f, f32(-np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - q),
                                    int(f32(c).view(np.uint32)) & 1))


def fused_route(w, t):
    """mmse_interp._fused_dot on numpy scalars: each product exact in
    float64, the running sum rounded to float64, then float32, a term."""
    acc = f32(float(w[0]) * float(t[0]))
    for k in range(1, 8):
        acc = f32(float(acc) + float(w[k]) * float(t[k]))
    return acc


def fma_route(w, t):
    """The same sum with fused multiply-adds (mm_fwd's speculation)."""
    acc = f32(f32(w[0]) * f32(t[0]))
    for k in range(1, 8):
        acc = fma32(w[k], t[k], acc)
    return acc


def engineer(taps):
    """An 8-sample float32 window, zero but at two taps k0 < k1, on which
    fma_route and fused_route differ for these taps: term k0 makes the
    running sum A in [1, 2) and term k1's product P lies within 2^-53 of an
    odd multiple of 2^-24 but off it, so that A + P rounded to float64 is a
    float32 midpoint, which the tie sends to the even neighbour and the
    exact sum to the other (A's last bit chosen so).  None where the taps
    have no two of magnitude 0.05 or more."""
    t = [f32(v) for v in taps]
    big = [k for k in range(8) if abs(float(t[k])) >= 0.05]
    for i, k0 in enumerate(big):
        for k1 in big[i + 1:]:
            for n in range(1, 1 << 14, 2):
                x = f32(n / (float(t[k1]) * 2.0 ** 24))
                for x1 in (x, np.nextafter(x, f32(np.inf)),
                           np.nextafter(x, f32(-np.inf))):
                    d = float(x1) * float(t[k1]) * 2.0 ** 24 - n   # exact
                    if not 0 < abs(d) < 2.0 ** -29:
                        continue
                    # the float below the midpoint: even if the exact sum
                    # lies above (d > 0), odd if below
                    j = ((n - 1) // 2 + (0 if d > 0 else 1)) % 2
                    a = f32(1.0 + j * 2.0 ** -23)
                    x0 = f32(float(a) / float(t[k0]))
                    for _ in range(8):
                        if f32(x0 * t[k0]) == a:
                            break
                        x0 = np.nextafter(x0, f32(np.inf) if abs(f32(x0 * t[k0]))
                                          < a else f32(0))
                    w = np.zeros(8, np.float32)
                    w[k0], w[k1] = x0, x1
                    if fma_route(w, t) != fused_route(w, t):
                        return w
    return None


def engineered(n, symbols, cplx=False, row=64, omega=10):
    """(x, window): n zero samples but for ``engineer(bank[row])``'s window
    at each of ``symbols`` (x[omega j:omega j + 8], in the imaginary part
    if cplx).  From mu = row / 128, base 0, a last sample of 0 and the
    nominal omega (an integer), a silent stream leaves the state as it is
    (the error is 0), so symbol j reads x[omega j:] at that row; the first
    such symbol the fused multiply-adds get wrong."""
    from grtpu_torch.ops.mmse_interp import mmse_taps

    w = engineer(mmse_taps()[row])
    x = np.zeros(n, np.complex64 if cplx else np.float32)
    for j in symbols:
        x[omega * j:omega * j + 8] = 1j * w if cplx else w
    return x, w
