"""The first-order IIR's two forms on the CPU: the plain arithmetic, and a
model of ``iir1_fwd``'s indexing.

``linear_recurrence_const`` and ``iir_filter`` route a CUDA tensor to the
``iir1_fwd`` kernel (``grtpu_torch.ops.cuda_iir``); a CPU tensor runs the
plain form.  That form is held here bit for bit (``torch.equal``) to a copy
of its arithmetic kept in this file, over fast poles, one, two and five
feed-forward taps, batched rows, complex64 rows and each kind of carried
state, chunk after chunk.  The series ``pole_series`` keeps per pole equal
``_pow_series``'s bit for bit.

The kernel cannot run here, so ``kernel_model`` below repeats its tiling
in numpy, index for index: the tile and its halo, the staged window and its
alignment slack, the skewed v, the register window of 8 outputs, the
staged stores, the history written back; every shared-memory access is
checked against the source's ``layout`` (``cuda_iir.layout``, by which the
wrapper refuses a window too large for shared memory).  The model sums in float64, so it
is held to the plain form within float32 rounding: sums of at most K + nff
terms whose magnitudes stay within the filter's DC gain 1 / (1 - |a|).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch.blocks.filter import IirFilter  # noqa: E402
from grtpu_torch.ops import cuda_iir, dsp  # noqa: E402
from grtpu_torch.ops.fir import as_taps, fir_filter, pad_last  # noqa: E402

# FmDeemph(32e3)'s taps (models/fm.py): the bilinear pole at 75 us
_K = np.tan(1.0 / (75e-6 * 2.0 * 32e3))
DEEMPH_FF, DEEMPH_FB = [_K / (1 + _K)] * 2, [1.0, (1 - _K) / (1 + _K)]
P1 = float(np.float32(DEEMPH_FB[1]))    # 0.651
POLES = [P1, 0.3, -0.5, 0.85]


# ---------------------------------------------- the arithmetic before iir1_fwd
def old_pow_series(a, start, n, device):
    e = torch.arange(start, start + n, dtype=torch.float64, device=device)
    base = torch.full((n,), a, dtype=torch.float64, device=device)
    return base.pow(e).to(torch.float32)


def old_scalar_like(v, ref):
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=ref.dtype)
    return torch.full((), float(v), dtype=ref.dtype, device=ref.device)


def old_linear_recurrence_const(a, b, y0, tol=1e-9):
    aa = float(a)
    ntaps = int(np.ceil(np.log(tol) / np.log(max(abs(aa), 1e-12)))) \
        if aa != 0.0 else 1
    assert ntaps <= 128
    taps = old_pow_series(aa, 0, ntaps, b.device)
    n = b.shape[-1]
    y = fir_filter(pad_last(b, ntaps - 1, 0), taps, 1)
    m = min(n, ntaps)
    corr = pad_last(old_pow_series(aa, 1, m, b.device), 0, n - m)
    y = y + old_scalar_like(y0, b).unsqueeze(-1) * corr
    return y, y[..., -1]


def old_iir_filter(x, state, fftaps, fbtaps):
    """iir_filter's first-order branch as it was."""
    ff = as_taps(fftaps, x.device)
    a1 = float(np.asarray(fbtaps, np.float32)[1])
    nff = ff.shape[0]
    x_hist, y_hist = state
    xs = torch.cat([x_hist, x]) if nff > 1 else x
    v = fir_filter(xs, ff, 1) if nff > 1 else x * ff[0]
    y, _ = old_linear_recurrence_const(a1, v, y_hist[-1])
    new_x_hist = xs[xs.shape[0] - (nff - 1):] if nff > 1 else x_hist
    return y, (new_x_hist, y[-1:])


def signal(shape, dtype, seed):
    r = np.random.RandomState(seed)
    x = r.randn(*shape)
    if dtype == torch.complex64:
        x = x + 1j * r.randn(*shape)
        return torch.from_numpy(x.astype(np.complex64))
    return torch.from_numpy(x.astype(np.float32))


def equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ------------------------------------------------------- the plain form
@pytest.mark.parametrize("a", POLES)
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("y0_kind", ["number", "scalar", "row"])
def test_linear_recurrence_const_unchanged_on_cpu(a, lead, dtype, y0_kind):
    """Three chunks (shorter than, about, and longer than the response)
    with the state carried, bit for bit the arithmetic before the kernel."""
    b = signal(lead + (300,), dtype, 1)
    y0 = {"number": 0.25,
          "scalar": torch.tensor(-0.5, dtype=dtype),
          "row": signal(lead, dtype, 2) if lead else torch.tensor(0.75)}[
        y0_kind]
    got_s, want_s = y0, y0
    for lo, hi in ((0, 7), (7, 60), (60, 300)):
        got, got_s = dsp.linear_recurrence_const(a, b[..., lo:hi], got_s)
        want, want_s = old_linear_recurrence_const(a, b[..., lo:hi], want_s)
        equal(got, want)
        equal(got_s, want_s)


@pytest.mark.parametrize("a", POLES)
@pytest.mark.parametrize("nff", [1, 2, 5])
def test_iir_filter_first_order_unchanged_on_cpu(a, nff):
    """Chunks of 1, 4, 49 and 400 samples through the first-order branch,
    the state carried: y and both histories bit for bit as before."""
    r = np.random.RandomState(nff)
    ff = r.randn(nff).astype(np.float32)
    fb = np.asarray([1.0, a], np.float32)
    x = signal((454,), torch.float32, 3)
    got_s = (torch.from_numpy(r.randn(nff - 1).astype(np.float32)),
             torch.tensor([0.3]))
    want_s = got_s
    lo = 0
    for n in (1, 4, 49, 400):
        got, got_s = dsp.iir_filter(x[lo:lo + n], got_s, ff, fb)
        want, want_s = old_iir_filter(x[lo:lo + n], want_s, ff, fb)
        lo += n
        equal(got, want)
        for g, w in zip(got_s, want_s):
            equal(g, w)


def test_fm_deemph_block_unchanged_on_cpu():
    """FmDeemph's IirFilter, as the WBFM receiver runs it, chunk by chunk."""
    blk = IirFilter(DEEMPH_FF, DEEMPH_FB)
    x = signal((3, 4096), torch.float32, 4)
    got_s = want_s = blk.init_state()
    for c in range(3):
        got_s, got = blk.apply(got_s, x[c])
        want, want_s = old_iir_filter(x[c], want_s, blk.ff, blk.fb)
        equal(got, want)
        for g, w in zip(got_s, want_s):
            equal(g, w)


@pytest.mark.parametrize("a", POLES + [0.0])
def test_pole_series_bit_for_bit(a):
    k = dsp._pole_taps(a)
    s0, s1 = dsp.pole_series(a, k, "cpu")
    equal(s0, dsp._pow_series(a, 0, k, "cpu"))
    equal(s1, dsp._pow_series(a, 1, k, "cpu"))
    equal(s0, old_pow_series(a, 0, k, "cpu"))
    assert dsp.pole_series(a, k, torch.device("cpu"))[0] is s0  # made once


def test_pole_taps():
    """49 taps for the de-emphasis pole at 32 kS/s; 128 is the last fast."""
    assert dsp._pole_taps(P1) == 49
    assert dsp._pole_taps(0.85) == 128 <= dsp.MAX_POLE_TAPS
    assert dsp._pole_taps(0.0) == 1
    assert dsp._pole_taps(0.9) > dsp.MAX_POLE_TAPS


def test_iir1_fwd_refuses_a_cpu_tensor():
    s0, s1 = dsp.pole_series(P1, 49, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_iir.iir1_fwd(torch.zeros(8), None, None, s0, s1, 0.0)


@pytest.mark.parametrize("rows,n,cplx,threads", [
    (1, 65536, False, 32),      # the WBFM chunk: 256 tiles of 256
    (64, 1 << 18, False, 128),  # a bank: 16,384 tiles of 1,024
    (1, 65536, True, 32),
    (2, 1 << 16, False, 32),
    (3, 1 << 16, False, 64),
    (1, 1, False, 32),
])
def test_threads_for(rows, n, cplx, threads):
    assert cuda_iir.threads_for(rows, n, cplx, 132) == threads


# -------------------------------------------- a model of iir1_fwd's tiling
R = 8


def layout(threads, c, kp, nff):
    """iir1.cu's ``layout`` (``cuda_iir.layout``, which the wrapper checks
    against shared memory): float offsets of taps, ff, xs, v and the
    total."""
    return cuda_iir.layout(threads, c == 2, kp, nff)


def kernel_model(x, hist, ff, apow, apow1, y0, threads, cplx):
    """iir1_kernel's arithmetic, index for index, in float64.  x (rows,
    n * C) float32, interleaved if complex; hist (rows, H * C) or None; ff
    (nff,) or None; y0 (rows, C) float64.  Returns (y, hist_out)."""
    c = 2 if cplx else 1
    rc = R * c
    rows, nc = x.shape
    n = nc // c
    k = len(apow)
    kp = -(-k // R) * R
    nff = 1 if ff is None else len(ff)
    h = nff - 1
    hc = h * c
    t = threads * R // c
    tiles = -(-n // t)
    vn = t + kp - 1
    o_taps, o_ff, o_xs, o_v, total = layout(threads, c, kp, nff)
    y = np.zeros((rows, nc))
    hist_out = np.zeros((rows, hc))

    def region(lo, hi, i):
        assert 0 <= i and lo + i < hi, (lo, hi, i)
        return i

    for row in range(rows):
        def fetch(g):
            if g >= 0:
                return float(x[row, g]) if g < nc else 0.0
            return float(hist[row, hc + g]) if g >= -hc else 0.0

        for tile in range(tiles):
            t0 = tile * t
            j0 = t0 - (kp - 1)
            taps = [float(apow[i]) if i < k else 0.0 for i in range(kp)]
            xs = np.zeros(o_v - o_xs)
            f0 = (j0 - h) * c
            shift = f0 & 3
            nvec = (shift + (vn + h) * c + 3) // 4
            for e in range(4 * nvec):
                xs[region(o_xs, o_v, e)] = fetch(f0 - shift + e)
            if h > 0 and tile == 0:
                hist_out[row] = [fetch(nc - hc + e) for e in range(hc)]
            vs = np.zeros(total - o_v)
            for f in range(vn * c):
                q, p = divmod(f, c)
                v = 0.0
                if j0 + q >= 0:
                    for m in range(nff):
                        w = 1.0 if ff is None else float(ff[m])
                        i = shift + (q + h) * c + p - m * c
                        v += w * xs[region(o_xs, o_v, i)]
                vs[region(o_v, total, f + f // rc)] = v
            stage_out = np.zeros(o_v - o_xs)
            for tid in range(threads):
                p, g = tid % c, tid // c

                def vat(q):
                    f = q * c + p
                    return vs[region(o_v, total, f + f // rc)]

                acc = [0.0] * R
                qb = g * R + kp - R
                u = [vat(qb + s) for s in range(2 * R - 1)]
                for kb in range(0, kp, R):
                    for j in range(R):
                        for r in range(R):
                            acc[r] += taps[kb + j] * u[r - j + R - 1]
                    if kb + R < kp:
                        u[R:] = u[:R - 1]
                        qb -= R
                        u[:R] = [vat(qb + s) for s in range(R)]
                i0 = t0 + g * R
                for r in range(R):
                    if i0 + r < k:
                        acc[r] += float(apow1[i0 + r]) * y0[row, p]
                    stage_out[region(o_xs, o_v, (g * R + r) * c + p)] = acc[r]
            count = min(n - t0, t) * c
            y[row, t0 * c:t0 * c + count] = stage_out[:count]
    return y, hist_out


def plain(x, hist, ff, a, k, y0):
    """The plain form on a (rows, n) float32 or complex64 tensor."""
    if ff is not None:
        x = torch.stack([fir_filter(torch.cat([hist[i], x[i]]), ff, 1)
                         for i in range(x.shape[0])])
    return dsp.truncated_plain(a, k, x, y0)


@pytest.mark.parametrize("a", POLES)
@pytest.mark.parametrize("nff", [1, 2, 5])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n,threads", [(1, 32), (48, 32), (49, 32),
                                       (300, 32), (530, 64)])
def test_kernel_model_matches_plain(a, nff, cplx, n, threads):
    """The kernel's tiling (several tiles a row where n > the tile, a tile
    shorter than the response at n 1 and 48) gives the plain form's y and
    the history after the chunk, within float32 rounding."""
    rows = 2
    dtype = torch.complex64 if cplx else torch.float32
    x = signal((rows, n), dtype, 5)
    r = np.random.RandomState(6)
    ff = None if nff == 1 else torch.from_numpy(r.randn(nff).astype(np.float32))
    hist = None if nff == 1 else signal((rows, nff - 1), dtype, 7)
    y0 = signal((rows,), dtype, 8)
    k = dsp._pole_taps(a)
    s0, s1 = dsp.pole_series(a, k, "cpu")
    want = plain(x, hist, ff, a, k, y0)

    def flat(t):
        return (torch.view_as_real(t) if cplx else t).reshape(rows, -1).numpy()

    y0c = flat(y0.reshape(rows, 1)).astype(np.float64)
    got, hist_out = kernel_model(flat(x), None if hist is None else flat(hist),
                                 None if ff is None else ff.numpy(), s0.numpy(),
                                 s1.numpy(), y0c, threads, cplx)
    gain = 1.0 / (1.0 - abs(a)) * (1 if ff is None else float(ff.abs().sum()))
    scale = gain * float(np.abs(flat(x)).max() + np.abs(y0c).max())
    assert np.abs(got - flat(want)).max() <= 2e-6 * scale
    if nff > 1:
        xs = torch.cat([hist, x], dim=-1)
        np.testing.assert_array_equal(hist_out, flat(xs[:, -(nff - 1):]))


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("threads", [32, 64, 128])
def test_window_fits_shared_memory(cplx, threads):
    """The staged window fits a block's shared memory for every pole the
    kernel takes (K <= MAX_POLE_TAPS) with a short feed-forward filter;
    a feed-forward filter of 30,000 taps does not (the wrapper refuses it
    on the card rather than launch)."""
    def nbytes(k, nff):
        return 4 * cuda_iir.layout(threads, cplx, k, nff)[-1]

    assert nbytes(dsp.MAX_POLE_TAPS, 5) <= cuda_iir.SMEM_OPTIN
    assert nbytes(1, 30000) > cuda_iir.SMEM_OPTIN
    # the window grows with the taps: C floats for each further tap
    c = 2 if cplx else 1
    assert nbytes(49, 1001) - nbytes(49, 1) == 4 * 1000 * (1 + c)
