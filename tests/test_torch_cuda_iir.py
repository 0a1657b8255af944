"""The first-order IIR kernel ``iir1_fwd`` on the card.

Every call of ``linear_recurrence_const``'s truncated branch and of
``iir_filter``'s first-order branch on a CUDA tensor is one launch of
``iir1_fwd``, held to the plain form on the CPU (the code a CPU tensor
runs) for poles FmDeemph's at 32 kS/s, 0.3, -0.5 and 0.85, one, two and
five feed-forward taps, one and three rows, 1 to 2^20 samples, a carried
state y0 != 0, float32 and complex64 rows.  The tolerance: each form sums K
+ nff float32 terms in its own order, so each rounds at most K + nff times,
each time by at most 2^-24 of a partial sum no larger than the response's
bound (the feed-forward taps' sum of magnitudes times the input's largest
magnitude over 1 - |a|, the DC gain, plus |y0|).  FmDeemph under
``run(device_loop=True)`` equals its eager run bit for bit, its launch
counted once a replay; a pole first seen inside a capture replays right.
An empty chunk launches nothing and leaves the state as it was; the largest
feed-forward filter whose window fits shared memory runs, and one tap more
is refused.
Every test needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.  The
file imports no JAX; from the repository root on a GPU machine:

    python -m pytest tests/test_torch_cuda_iir.py -m cuda --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grtpu_torch import Graph, Port, StreamExecutor  # noqa: E402
from grtpu_torch.models.fm import FmDeemph  # noqa: E402
from grtpu_torch.ops import cuda_fir, cuda_iir, dsp  # noqa: E402
from grtpu_torch.ops.fir import fir_filter  # noqa: E402

pytestmark = pytest.mark.cuda

_K = np.tan(1.0 / (75e-6 * 2.0 * 32e3))      # FmDeemph(32e3)'s bilinear pole
P1 = float(np.float32((1 - _K) / (1 + _K)))
POLES = [P1, 0.3, -0.5, 0.85]
LENGTHS = [1, 48, 49, 65536, 1 << 20]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def signal(shape, dtype, seed):
    r = np.random.RandomState(seed)
    x = r.randn(*shape)
    if dtype == torch.complex64:
        x = x + 1j * r.randn(*shape)
        return torch.from_numpy(x.astype(np.complex64))
    return torch.from_numpy(x.astype(np.float32))


def plain(x, hist, ff, a, k, y0):
    """The plain form on the CPU: the feed-forward FIR over the history and
    the chunk, then the truncated response."""
    v = x if ff is None else fir_filter(torch.cat([hist, x], dim=-1), ff, 1)
    return dsp.truncated_plain(a, k, v, y0)


def one_launch(fn):
    before = dict(cuda_fir.launches)
    out = fn()
    moved = {n: cuda_fir.launches[n] - before[n] for n in before
             if cuda_fir.launches[n] != before[n]}
    assert moved == {"iir1_fwd": 1}
    return out


def check(got, want, x, ff, a, k, y0):
    nff = 1 if ff is None else ff.shape[0]
    gain = 1.0 if ff is None else float(ff.abs().sum())
    scale = gain * float(x.abs().max()) / (1 - abs(a)) + float(y0.abs().max())
    tol = 2 * (k + nff) * 2.0 ** -24 * scale
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.parametrize("a", POLES)
@pytest.mark.parametrize("nff", [1, 2, 5])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_iir1_fwd_against_the_plain_form(dev, a, nff, rows, n, dtype):
    """nff 1 through linear_recurrence_const (rows on a leading axis); a
    real row with feed-forward taps through iir_filter; the rest through
    the wrapper, as those two call it."""
    x = signal((rows, n), dtype, 1)
    y0 = signal((rows,), dtype, 2)
    r = np.random.RandomState(3)
    ff = None if nff == 1 else torch.from_numpy(r.randn(nff).astype(np.float32))
    hist = None if nff == 1 else signal((rows, nff - 1), dtype, 4)
    k = dsp._pole_taps(a)
    want = plain(x, hist, ff, a, k, y0)
    xd, y0d = x.to(dev), y0.to(dev)
    if ff is None:
        got, last = one_launch(lambda: dsp.linear_recurrence_const(a, xd, y0d))
        assert torch.equal(last, got[..., -1])
    elif rows == 1 and dtype == torch.float32:
        state = (hist[0].to(dev), y0d)
        got, (xh, yh) = one_launch(lambda: dsp.iir_filter(
            xd[0], state, ff.to(dev), np.asarray([1.0, a], np.float32)))
        got = got[None]
        xs = torch.cat([hist, x], dim=-1)
        assert torch.equal(xh.cpu(), xs[0, -(nff - 1):])
        assert torch.equal(yh, got[0, -1:])
    else:
        s0, s1 = dsp.pole_series(a, k, dev)
        got, xh = one_launch(lambda: cuda_iir.iir1_fwd(
            xd, hist.to(dev), ff.to(dev), s0, s1, y0d))
        xs = torch.cat([hist, x], dim=-1)
        assert torch.equal(xh.cpu(), xs[:, -(nff - 1):])
    check(got, want, x, ff, a, k, y0)


@pytest.mark.parametrize("y0", [0.0, -1.5, "scalar"])
def test_state_kinds(dev, y0):
    """y0 as a number and as one value on the card, for every row."""
    x = signal((3, 1000), torch.float32, 5)
    if y0 == "scalar":
        y0 = torch.tensor(0.7)
    want, _ = dsp.linear_recurrence_const(0.5, x, y0)
    got, _ = one_launch(lambda: dsp.linear_recurrence_const(
        0.5, x.to(dev), y0.to(dev) if isinstance(y0, torch.Tensor) else y0))
    check(got, want, x, None, 0.5, dsp._pole_taps(0.5),
          torch.as_tensor(y0))


def test_series_made_once_and_equal(dev):
    k = dsp._pole_taps(P1)
    s0, s1 = dsp.pole_series(P1, k, dev)
    assert torch.equal(s0.cpu(), dsp._pow_series(P1, 0, k, "cpu"))
    assert torch.equal(s1.cpu(), dsp._pow_series(P1, 1, k, "cpu"))
    assert dsp.pole_series(P1, k, dev)[0] is s0


def deemph_graph():
    g = Graph()
    g.connect(g.add_input(Port(torch.float32)), FmDeemph(32e3, 75e-6),
              g.add_output(Port(torch.float32)))
    return g


def test_fm_deemph_device_loop_equals_eager_and_counts_replays(dev):
    """Eight chunks of 65,536, run twice in each mode: device_loop equals
    eager bit for bit, and iir1_fwd counts one launch a chunk (the first
    eagerly, then one a replay)."""
    x = signal((8 * 65536,), torch.float32, 6).to(dev)
    eager = StreamExecutor(deemph_graph(), chunk_size=65536, device=dev)
    loop = StreamExecutor(deemph_graph(), chunk_size=65536, device=dev)
    want = [eager.run(x) for _ in range(2)]
    before = cuda_fir.launches["iir1_fwd"]
    got = [loop.run(x, device_loop=True) for _ in range(2)]
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert torch.equal(g, w)
    assert cuda_fir.launches["iir1_fwd"] - before == 16
    assert loop.loop_stats()["replays"] == 15
    last = cuda_fir.launches["iir1_fwd"]
    loop.run(x[:65536], device_loop=True)
    torch.cuda.synchronize()
    assert cuda_fir.launches["iir1_fwd"] - last == 1


def test_pole_first_seen_in_a_capture(dev):
    """A pole whose series are not kept yet is made inside the graph and
    not kept; the replays give the eager result."""
    a = 0.123456
    x = signal((2, 4096), torch.float32, 7).to(dev)
    y0 = torch.zeros(2, device=dev)
    k = dsp._pole_taps(a)
    assert (a, k, x.device) not in dsp._POLE_SERIES
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph):
            out, _ = dsp.linear_recurrence_const(a, x, y0)
    assert (a, k, x.device) not in dsp._POLE_SERIES
    graph.replay()
    want, _ = dsp.linear_recurrence_const(a, x, y0)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_zero_length_chunk(dev):
    """An empty chunk through iir_filter's first-order branch: no launch, an
    empty y, the state as it was; the next chunk gives what it gives
    without the empty one."""
    ff = torch.tensor([0.2, 0.3], device=dev)
    fb = np.asarray([1.0, P1], np.float32)
    x = signal((1000,), torch.float32, 8).to(dev)
    state = (torch.tensor([0.5], device=dev), torch.tensor([-0.25], device=dev))
    before = dict(cuda_fir.launches)
    y, (xh, yh) = dsp.iir_filter(x[:0], state, ff, fb)
    assert cuda_fir.launches == before
    assert y.shape == (0,) and xh is state[0] and yh is state[1]
    got, _ = one_launch(lambda: dsp.iir_filter(x, (xh, yh), ff, fb))
    want, _ = dsp.iir_filter(x, state, ff, fb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_largest_feed_forward_filter(dev):
    """The most feed-forward taps whose staged window fits a block's shared
    memory (227 KB) run and hold to the plain form; one more is refused
    with a ValueError before any launch."""
    a, n = P1, 4096
    k = dsp._pole_taps(a)
    threads = cuda_iir.threads_for(1, n, False, torch.cuda.get_device_properties(
        dev).multi_processor_count)

    def fits(nff):
        return 4 * cuda_iir.layout(threads, False, k, nff)[-1] \
            <= cuda_iir.SMEM_OPTIN

    nff = 1
    while fits(nff + 1):
        nff += 1
    r = np.random.RandomState(9)
    ff = torch.from_numpy((r.randn(nff) / nff).astype(np.float32))
    x = signal((1, n), torch.float32, 10)
    hist = signal((1, nff - 1), torch.float32, 11)
    y0 = signal((1,), torch.float32, 12)
    s0, s1 = dsp.pole_series(a, k, dev)
    got, xh = one_launch(lambda: cuda_iir.iir1_fwd(
        x.to(dev), hist.to(dev), ff.to(dev), s0, s1, y0.to(dev)))
    check(got, plain(x, hist, ff, a, k, y0), x, ff, a, k, y0)
    assert torch.equal(xh.cpu(), torch.cat([hist, x], dim=-1)[:, -(nff - 1):])
    big = torch.zeros(nff + 1, device=dev)
    before = dict(cuda_fir.launches)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_iir.iir1_fwd(x.to(dev), torch.zeros(1, nff, device=dev), big, s0,
                          s1, y0.to(dev))
    assert cuda_fir.launches == before
