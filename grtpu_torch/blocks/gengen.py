"""Elementwise / generated ops: the gengen layer (port of
``grtpu.blocks.gengen``).

Analog of gnuradio-core/src/lib/gengen: add, add_const, sub, multiply,
multiply_const, divide, and/or/xor/not, integrate, moving_average, argmax,
max, mute, sample_and_hold, peak_detector, noise_source_X,
vector_source_X / vector_sink_X, chunks_to_symbols_XX,
packed_to_unpacked_XX / unpacked_to_packed_XX.

Each op is one dtype-parameterized Block class, with gr-style suffix
factories (``add_ff``, ``multiply_const_cc``, ...) for API parity.  Lookup
tables stay host numpy; each block keeps one copy per device it has run on.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from grtpu_torch.ops import noise
from grtpu_torch.runtime.block import Block, Port, torch_dtype
from grtpu_torch.utils.device import resolve


def _scalar(k, dtype: torch.dtype):
    """``k`` as the Python scalar of a torch dtype's kind, rounded to that
    dtype (grtpu stores ``np.dtype(dtype).type(k)``)."""
    return torch.tensor(k, dtype=dtype).item()


def _cached_on(cache: dict, device, host) -> torch.Tensor:
    """The device copy of a host array, made once per device."""
    t = cache.get(device)
    if t is None:
        t = cache[device] = torch.as_tensor(host).to(device)
    return t


def _msb_first_shifts(m: int, k: int, device) -> torch.Tensor:
    return torch.arange(m - 1, -1, -1, dtype=torch.int32, device=device) * k


# --------------------------------------------------------------------- n-ary
class _NaryElementwise(Block):
    """N inputs -> one output, elementwise, stateless."""

    def __init__(self, dtype=torch.float32, nin: int = 2, vlen: int = 1,
                 name=None):
        self.in_ports = tuple(Port(dtype, vlen) for _ in range(nin))
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, *xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = self._combine(acc, x)
        return state, acc

    def _combine(self, a, b):
        raise NotImplementedError


class Add(_NaryElementwise):
    def _combine(self, a, b):
        return a + b


class Sub(_NaryElementwise):
    def _combine(self, a, b):
        return a - b


class Multiply(_NaryElementwise):
    def _combine(self, a, b):
        return a * b


class Divide(_NaryElementwise):
    def _combine(self, a, b):
        return a / b


class And(_NaryElementwise):
    def _combine(self, a, b):
        return a & b


class Or(_NaryElementwise):
    def _combine(self, a, b):
        return a | b


class Xor(_NaryElementwise):
    def _combine(self, a, b):
        return a ^ b


class Not(Block):
    def __init__(self, dtype=torch.int32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, x):
        return state, ~x


# ------------------------------------------------------------------- x_const
class AddConst(Block):
    def __init__(self, k, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.k = _scalar(k, self.in_ports[0].dtype)

    def apply(self, state, x):
        return state, x + self.k

    def set_k(self, k):
        self.k = _scalar(k, self.in_ports[0].dtype)
        self.touch()


class MultiplyConst(Block):
    def __init__(self, k, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.k = _scalar(k, self.in_ports[0].dtype)

    def apply(self, state, x):
        return state, x * self.k

    def set_k(self, k):
        self.k = _scalar(k, self.in_ports[0].dtype)
        self.touch()


class AndConst(Block):
    def __init__(self, k, dtype=torch.uint8, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.k = int(k)

    def apply(self, state, x):
        return state, x & self.k


# ----------------------------------------------------------------- stateful
class Integrate(Block):
    """Decimating integrator: sum groups of ``decim`` samples
    (gengen gr_integrate_XX)."""

    def __init__(self, decim: int, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.decim = decim
        super().__init__(name)

    def apply(self, state, x):
        n = x.shape[0]
        return state, x.reshape(n // self.decim, self.decim).sum(dim=1).to(
            x.dtype)


class MovingAverage(Block):
    """Sliding-window sum scaled by ``scale`` (gr_moving_average_XX).

    Uses executor-managed history for exact cross-chunk windows; computed as
    a cumulative-sum difference."""

    def __init__(self, length: int, scale=1, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.length = length
        self.scale = scale
        self.history = length
        super().__init__(name)

    def apply(self, state, x):
        # x has length n + length - 1; output n sliding sums.
        acc = x if (x.is_floating_point() or x.is_complex()) \
            else x.to(torch.int64)
        c = torch.cumsum(acc, dim=0)
        c = torch.cat([c.new_zeros((1,)), c])
        win = c[self.length:] - c[:-self.length]
        return state, (win * self.scale).to(x.dtype)


class SampleAndHold(Block):
    """Output held input value gated by a control stream
    (gr_sample_and_hold_XX): out[i] = in[i] if ctrl[i] else previous held.

    Closed form of grtpu's scan: each output reads the input at the last
    index where the control was set (a running maximum over those indices),
    or the carried value before the first one."""

    def __init__(self, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype), Port(torch.uint8))
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self._dtype = self.in_ports[0].dtype

    def init_state(self):
        return torch.zeros((), dtype=self._dtype)

    def apply(self, state, x, ctrl):
        n = x.shape[0]
        idx = torch.arange(n, device=x.device)
        last = torch.cummax(torch.where(ctrl != 0, idx, idx.new_full((), -1)),
                            dim=0).values
        y = torch.where(last >= 0, x[last.clamp(min=0)], state.to(x.dtype))
        return y[-1], y


class PeakDetector(Block):
    """Flag the peak of each burst above a threshold envelope
    (gr_peak_detector_XX semantics: tracks a running peak between
    threshold crossings; emits 1 at the peak sample).

    A per-sample recursion (grtpu's ``lax.scan``), run here as a loop of
    0-d tensor operations on the stream's device in the same float32
    arithmetic."""

    def __init__(self, threshold_factor_rise=0.25, threshold_factor_fall=0.40,
                 look_ahead=10, alpha=0.001, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.tfr, self.tff = threshold_factor_rise, threshold_factor_fall
        self.alpha = alpha

    def init_state(self):
        # (avg, peak_val, peak_ind_rel, in_burst)
        return (torch.zeros(()), torch.zeros(()),
                torch.zeros((), dtype=torch.int32),
                torch.zeros((), dtype=torch.bool))

    def apply(self, state, x):
        alpha, tfr, tff = self.alpha, self.tfr, self.tff
        n = x.shape[0]
        avg, peak, peak_i, burst = state
        xs = x.to(torch.float32)
        idx = torch.arange(n, dtype=torch.int32, device=x.device)
        zero = xs.new_zeros(())
        out = torch.zeros((n,), dtype=torch.uint8, device=x.device)
        one = out.new_ones(())
        for i in range(n):
            v = xs[i]
            avg = (1 - alpha) * avg + alpha * v
            start = (~burst) & (v > avg * (1 + tfr))
            burst = burst | start
            better = burst & (v > peak)
            peak = torch.where(better | start, v, peak)
            peak_i = torch.where(better | start, idx[i], peak_i)
            end = burst & (v < avg * (1 - tff))
            # a burst that ends flags its peak, by its index in the chunk
            # the peak was seen in
            pos = peak_i.clamp(0, n - 1).long()
            out[pos] = torch.where(end & (peak_i < n), one, out[pos])
            peak = torch.where(end, zero, peak)
            burst = burst & (~end)
        return (avg, peak, peak_i, burst), out


class Argmax(Block):
    """Per-vector argmax (gr_argmax_XX): vlen-vector in, index out."""

    def __init__(self, vlen: int, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(torch.int16),)
        super().__init__(name)

    def apply(self, state, x):
        return state, torch.argmax(x, dim=-1).to(torch.int16)


class Max(Block):
    """Per-vector max (gr_max_XX)."""

    def __init__(self, vlen: int, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)

    def apply(self, state, x):
        return state, torch.amax(x, dim=-1)


class Mute(Block):
    def __init__(self, mute: bool = False, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.muted = mute

    def set_mute(self, m: bool):
        self.muted = m
        self.touch()

    def apply(self, state, x):
        return state, torch.zeros_like(x) if self.muted else x


# ----------------------------------------------------------------- sources
class VectorSource(Block):
    """Repeat (or play once) a fixed vector (gengen gr_vector_source_X)."""

    def __init__(self, data, repeat: bool = False, dtype=None, vlen: int = 1,
                 name=None):
        arr = torch.as_tensor(np.asarray(data))
        if dtype is not None:
            arr = arr.to(torch_dtype(dtype))
        self.out_ports = (Port(arr.dtype, vlen),)
        super().__init__(name)
        if vlen > 1:
            arr = arr.reshape(-1, vlen)
        self.data = arr
        self.repeat = repeat
        self._data_dev = {}

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)  # read position

    def apply(self, state, n: int):
        data = self._data_dev.get(state.device)
        if data is None:
            data = self._data_dev[state.device] = self.data.to(state.device)
        m = data.shape[0]
        pos = state + torch.arange(n, device=state.device)
        y = data[pos % m]
        if not self.repeat:
            # past-the-end samples are zeroed (finite runs)
            mask = (pos < m).reshape((n,) + (1,) * (y.ndim - 1))
            y = y * mask.to(y.dtype)
        return ((state + n) % m if self.repeat else state + n), y


class NullSource(Block):
    # stateless, so the executor names the device to produce on
    source_takes_device = True

    def __init__(self, dtype=torch.float32, vlen: int = 1, name=None):
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, n: int, device=None):
        port = self.out_ports[0]
        return state, torch.zeros(port.chunk_shape(n), dtype=port.dtype,
                                  device=resolve(device))


class NoiseSource(Block):
    """Gaussian/uniform noise source (gr_noise_source_X + gr_random).

    Sample i of the stream is a function of (seed, i) alone
    (``ops.noise``): the carried state is the count of samples drawn, so a
    run resumed from a checkpoint continues the stream bit for bit, on any
    device and under ``run(device_loop=True)``.  grtpu carries a JAX PRNG
    key instead: the two packages' noise streams differ, and a checkpoint
    of a graph that holds a NoiseSource does not move between them.
    """

    def __init__(self, kind: str = "gaussian", amplitude: float = 1.0,
                 seed: int = 0, dtype=torch.float32, name=None):
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        if kind not in ("gaussian", "uniform"):
            raise ValueError(f"unknown noise kind {kind}")
        self.kind = kind
        self.amplitude = amplitude
        self.seed = seed
        self._dtype = self.out_ports[0].dtype

    def init_state(self):
        return torch.zeros((), dtype=torch.int64)

    def apply(self, state, n: int):
        cplx = self._dtype.is_complex
        if self.kind == "gaussian":
            re, im = noise.normal_pair(self.seed, state, n)
            amp = self.amplitude / np.sqrt(2) if cplx else self.amplitude
        else:
            re = noise.uniform(self.seed, state, n, 0) * 2.0 - 1.0
            im = noise.uniform(self.seed, state, n, 1) * 2.0 - 1.0 \
                if cplx else None
            amp = self.amplitude
        y = torch.complex(re, im) * amp if cplx else re * amp
        return state + n, y.to(self._dtype)


# ------------------------------------------------------------------- sinks
class VectorSink(Block):
    """Collect everything (gr_vector_sink_X).

    After ``executor.run(...)`` the samples are in ``self.captured[0]`` (a
    tensor on the executor's device); :meth:`data` returns them as numpy.
    """

    def __init__(self, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def data(self):
        return None if self.captured is None else self.captured[0].cpu().numpy()


class NullSink(Block):
    def __init__(self, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()


class ProbeSignal(Block):
    """Expose the most recent sample to the host (gr_probe_signal_f)."""

    def __init__(self, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def level(self):
        return None if self.captured is None \
            else self.captured[0][-1].cpu().numpy()[()]


# ------------------------------------------------------- symbol/bit packing
class ChunksToSymbols(Block):
    """Map integer chunks to symbol-table entries
    (gengen gr_chunks_to_symbols_XX: out[i] = table[in[i]])."""

    def __init__(self, symbol_table, in_dtype=torch.uint8,
                 out_dtype=torch.complex64, dimension: int = 1, name=None):
        self.in_ports = (Port(in_dtype),)
        self.out_ports = (Port(out_dtype),)
        self.interp = dimension
        super().__init__(name)
        self.table = torch.as_tensor(np.asarray(symbol_table)).to(
            self.out_ports[0].dtype).numpy()
        self.dimension = dimension
        self._table_dev = {}

    def apply(self, state, x):
        idx = x.long()
        table = _cached_on(self._table_dev, x.device, self.table)
        if self.dimension == 1:
            return state, table[idx]
        return state, table.reshape(-1, self.dimension)[idx].reshape(-1)


class PackedToUnpacked(Block):
    """Explode packed bytes into k-bit chunks, MSB first
    (gr_packed_to_unpacked_XX with GR_MSB_FIRST)."""

    def __init__(self, bits_per_chunk: int = 1, dtype=torch.uint8, name=None):
        assert 8 % bits_per_chunk == 0, "bits_per_chunk must divide 8"
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.interp = 8 // bits_per_chunk
        super().__init__(name)
        self.k = bits_per_chunk

    def apply(self, state, x):
        k, m = self.k, self.interp
        shifts = _msb_first_shifts(m, k, x.device)
        out = (x[:, None].to(torch.int32) >> shifts[None, :]) & ((1 << k) - 1)
        return state, out.reshape(-1).to(x.dtype)


class UnpackedToPacked(Block):
    """Pack k-bit chunks into bytes, MSB first (gr_unpacked_to_packed_XX)."""

    def __init__(self, bits_per_chunk: int = 1, dtype=torch.uint8, name=None):
        assert 8 % bits_per_chunk == 0
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.decim = 8 // bits_per_chunk
        super().__init__(name)
        self.k = bits_per_chunk

    def apply(self, state, x):
        k, m = self.k, self.decim
        g = x.reshape(-1, m).to(torch.int32)
        shifts = _msb_first_shifts(m, k, x.device)
        packed = ((g & ((1 << k) - 1)) << shifts[None, :]).sum(dim=1)
        return state, packed.to(x.dtype)


class PackKBits(Block):
    """gr_pack_k_bits_bb: pack k input bits (LSB of each byte) per output."""

    def __init__(self, k: int, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        self.decim = k
        super().__init__(name)
        self.k = k

    def apply(self, state, x):
        g = x.reshape(-1, self.k).to(torch.int32) & 1
        shifts = _msb_first_shifts(self.k, 1, x.device)
        return state, (g << shifts[None, :]).sum(dim=1).to(torch.uint8)


class UnpackKBits(Block):
    """gr_unpack_k_bits_bb: one bit per output byte, MSB first within k."""

    def __init__(self, k: int, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        self.interp = k
        super().__init__(name)
        self.k = k

    def apply(self, state, x):
        shifts = _msb_first_shifts(self.k, 1, x.device)
        out = (x[:, None].to(torch.int32) >> shifts[None, :]) & 1
        return state, out.reshape(-1).to(torch.uint8)


class MapBB(Block):
    """gr_map_bb: out = table[in]."""

    def __init__(self, table: Sequence[int], name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.table = np.asarray(table, np.uint8)
        self._table_dev = {}

    def apply(self, state, x):
        return state, _cached_on(self._table_dev, x.device,
                                 self.table)[x.long()]


# ---------------------------------------------------------- suffix aliases
def _suffix_factories():
    """gr-style typed factories: add_ff, multiply_cc, ... (API parity)."""
    suffix_dtype = {
        "b": torch.uint8, "s": torch.int16, "i": torch.int32,
        "f": torch.float32, "c": torch.complex64,
    }
    out = {}
    for opname, cls in [("add", Add), ("sub", Sub), ("multiply", Multiply),
                        ("divide", Divide), ("add_const", AddConst),
                        ("multiply_const", MultiplyConst)]:
        for sfx, dt in suffix_dtype.items():
            out[f"{opname}_{sfx}{sfx}"] = functools.partial(cls, dtype=dt)
    for sfx, dt in suffix_dtype.items():
        out[f"vector_source_{sfx}"] = functools.partial(VectorSource, dtype=dt)
        out[f"vector_sink_{sfx}"] = functools.partial(VectorSink, dtype=dt)
        out[f"null_source_{sfx}"] = functools.partial(NullSource, dtype=dt)
        out[f"null_sink_{sfx}"] = functools.partial(NullSink, dtype=dt)
        out[f"noise_source_{sfx}"] = functools.partial(NoiseSource, dtype=dt)
    return out


globals().update(_suffix_factories())
