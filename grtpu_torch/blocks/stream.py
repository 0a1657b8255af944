"""Stream plumbing blocks (port of ``grtpu.blocks.stream``).

Analogs of gnuradio-core/src/lib/general stream utilities:
gr_stream_to_vector, gr_vector_to_stream, gr_keep_one_in_n, gr_repeat,
gr_delay, gr_skiphead, gr_head, gr_copy, gr_interleave, gr_deinterleave,
gr_stream_mux, gr_throttle.

Under the time-block execution model some of these change character:
* gr_throttle paced a free-running graph against the wall clock; here the
  executor is pull-driven, so Throttle is a pass-through kept for API parity.
* gr_head bounded a free-running graph; finite runs are the default here
  (``executor.run`` over finite arrays / ``steps=``), so Head zero-masks
  items past N unless ``compact=True``.
"""

from __future__ import annotations

import torch

from grtpu_torch.runtime.block import Block, Port


class Copy(Block):
    """gr_copy / gr_kludge_copy / gr_nop: identity."""

    def __init__(self, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, x):
        return state, x


class Throttle(Copy):
    """API-parity pass-through (see module docstring)."""


class StreamToVector(Block):
    """Group nitems_per_block scalars into one vector item
    (gr_stream_to_vector)."""

    def __init__(self, dtype, vlen: int, name=None):
        self.in_ports = (Port(dtype, 1),)
        self.out_ports = (Port(dtype, vlen),)
        self.decim = vlen
        super().__init__(name)
        self.vlen = vlen

    def apply(self, state, x):
        return state, x.reshape(-1, self.vlen)


class VectorToStream(Block):
    """gr_vector_to_stream."""

    def __init__(self, dtype, vlen: int, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, 1),)
        self.interp = vlen
        super().__init__(name)

    def apply(self, state, x):
        return state, x.reshape(-1)


class KeepOneInN(Block):
    """gr_keep_one_in_n: emit the last of every n samples."""

    def __init__(self, n: int, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        self.decim = n
        super().__init__(name)
        self.n = n

    def apply(self, state, x):
        return state, x[self.n - 1::self.n]


class Repeat(Block):
    """gr_repeat: emit each sample ``interp`` times."""

    def __init__(self, interp: int, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.interp = interp
        super().__init__(name)

    def apply(self, state, x):
        return state, torch.repeat_interleave(x, self.interp)


class Delay(Block):
    """gr_delay: shift the stream by d zero samples (carried tail state)."""

    def __init__(self, d: int, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.d = d
        self._port = self.in_ports[0]

    def init_state(self):
        return torch.zeros(self._port.chunk_shape(self.d),
                           dtype=self._port.dtype)

    def apply(self, state, x):
        if self.d == 0:
            return state, x
        full = torch.cat([state, x], dim=0)
        return full[full.shape[0] - self.d:], full[: x.shape[0]]


def _item_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-item mask shaped to broadcast over x's trailing item axes."""
    return mask.reshape((-1,) + (1,) * (x.ndim - 1))


class SkipHead(Block):
    """gr_skiphead: suppress the first N items.

    compact=True gives the reference's exact semantics (the output stream
    IS N items shorter) through the executor's variable-rate machinery: the
    chunk is rotated so the surviving items form a valid prefix and n_valid
    counts them.  The default is the fixed-rate zero-mask form (consumers
    slice ``sink.data()[N:]``)."""

    def __init__(self, n: int, dtype=torch.float32, vlen: int = 1,
                 compact: bool = False, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        self.variable_rate = bool(compact)
        super().__init__(name)
        self.n = n

    def max_out_for(self, n_delivered: int) -> int:
        return n_delivered

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)

    def apply(self, state, x):
        n = x.shape[0]
        if self.variable_rate:
            skip = torch.clamp(self.n - state, 0, n)
            # roll by a device-resident count, without a host read
            idx = (torch.arange(n, device=x.device) + skip) % n
            return state + n, (x[idx], (n - skip).to(torch.int32))
        pos = state + torch.arange(n, device=x.device)
        return state + n, torch.where(_item_mask(pos >= self.n, x), x,
                                      torch.zeros_like(x))


class Head(Block):
    """gr_head: pass the first N items.

    compact=True gives the reference's exact finite-run semantics (the
    output stream ENDS after N items — downstream sinks receive exactly N)
    as a variable-rate block; the default is the fixed-rate zero-after-N
    form."""

    def __init__(self, n: int, dtype=torch.float32, vlen: int = 1,
                 compact: bool = False, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        self.variable_rate = bool(compact)
        super().__init__(name)
        self.n = n

    def max_out_for(self, n_delivered: int) -> int:
        return n_delivered

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)

    def apply(self, state, x):
        n = x.shape[0]
        if self.variable_rate:
            n_valid = torch.clamp(self.n - state, 0, n).to(torch.int32)
            return state + n, (x, n_valid)
        pos = state + torch.arange(n, device=x.device)
        return state + n, torch.where(_item_mask(pos < self.n, x), x,
                                      torch.zeros_like(x))


class Interleave(Block):
    """gr_interleave: N streams -> 1 stream, round-robin."""

    def __init__(self, nin: int, dtype=torch.float32, name=None):
        self.in_ports = tuple(Port(dtype) for _ in range(nin))
        self.out_ports = (Port(dtype),)
        self.interp = nin
        super().__init__(name)

    def apply(self, state, *xs):
        return state, torch.stack(xs, dim=1).reshape(-1)


class Deinterleave(Block):
    """gr_deinterleave: 1 stream -> N streams, round-robin."""

    def __init__(self, nout: int, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = tuple(Port(dtype) for _ in range(nout))
        self.decim = nout
        super().__init__(name)
        self.nout = nout

    def apply(self, state, x):
        g = x.reshape(-1, self.nout)
        return state, tuple(g[:, i] for i in range(self.nout))


class StreamMux(Block):
    """gr_stream_mux: interleave runs of lengths[i] items from each input.

    All inputs are consumed at the same per-step rate in this static model,
    so lengths must be equal-rate compatible (sum(lengths) divides the step).
    """

    def __init__(self, lengths, dtype=torch.float32, name=None):
        self.in_ports = tuple(Port(dtype) for _ in lengths)
        self.out_ports = (Port(dtype),)
        self.interp = len(lengths)
        super().__init__(name)
        self.lengths = tuple(int(l) for l in lengths)
        if len(set(self.lengths)) != 1:
            raise NotImplementedError(
                "StreamMux currently supports equal run lengths per input")

    def apply(self, state, *xs):
        L = self.lengths[0]
        blocks = [x.reshape(-1, L) for x in xs]
        return state, torch.stack(blocks, dim=1).reshape(-1)


class StreamToStreams(Deinterleave):
    """gr_stream_to_streams == deinterleave."""


class StreamsToStream(Interleave):
    """gr_streams_to_stream == interleave."""


class StreamsToVector(Block):
    """gr_streams_to_vector: N parallel scalar streams -> one N-vector
    stream (item i of the vector = stream i)."""

    def __init__(self, dtype, nstreams: int, name=None):
        self.in_ports = tuple(Port(dtype, 1) for _ in range(nstreams))
        self.out_ports = (Port(dtype, nstreams),)
        super().__init__(name)
        self.n = nstreams

    def apply(self, state, *xs):
        return state, torch.stack(xs, dim=1)


class VectorToStreams(Block):
    """gr_vector_to_streams: one N-vector stream -> N scalar streams."""

    def __init__(self, dtype, nstreams: int, name=None):
        self.in_ports = (Port(dtype, nstreams),)
        self.out_ports = tuple(Port(dtype, 1) for _ in range(nstreams))
        super().__init__(name)
        self.n = nstreams

    def apply(self, state, x):
        return state, tuple(x[:, i] for i in range(self.n))
