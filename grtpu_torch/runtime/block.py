"""Block protocol: the analog of ``gr_block``, over torch tensors.

Port of ``grtpu.runtime.block``.  A Block is a function over a time-block:

    state', (y0, y1, ...) = block.apply(state, x0, x1, ...)

where each input ``xi`` carries ``n + history - 1`` items — the executor
prepends the last ``history - 1`` items of the previous time-block (the
halo).  Each output holds exactly ``n // decim * interp`` items.

State is a tensor, a tuple or NamedTuple of tensors, or ``()`` for a
stateless block.  The executor moves it to its device and carries it between
time-blocks, so a whole flowgraph checkpoints by saving those tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np
import torch

_NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a numpy type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NUMPY_TO_TORCH[np.dtype(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch dtype, a numpy dtype or a numpy type (for
    data read or made on the host)."""
    if isinstance(dtype, torch.dtype):
        return next(k for k, v in _NUMPY_TO_TORCH.items() if v == dtype)
    return np.dtype(dtype)


@dataclasses.dataclass(frozen=True)
class Port:
    """Typed stream endpoint: torch dtype + per-item vector length.

    A stream with vlen == 1 is a rank-1 tensor of shape (n,); vlen > 1 is
    rank-2 of shape (n, vlen).  ``dtype`` may be given as a torch or numpy
    dtype and is held as a torch dtype.
    """

    dtype: Any
    vlen: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))
        if self.vlen < 1:
            raise ValueError(f"vlen must be >= 1, got {self.vlen}")

    def item_shape(self) -> Tuple[int, ...]:
        return () if self.vlen == 1 else (self.vlen,)

    def chunk_shape(self, n: int) -> Tuple[int, ...]:
        return (n,) + self.item_shape()

    def compatible(self, other: "Port") -> bool:
        return self.dtype == other.dtype and self.vlen == other.vlen

    def __repr__(self):
        return f"Port({str(self.dtype).replace('torch.', '')}, vlen={self.vlen})"


def port_b(vlen: int = 1) -> Port:
    return Port(torch.uint8, vlen)


def port_s(vlen: int = 1) -> Port:
    return Port(torch.int16, vlen)


def port_i(vlen: int = 1) -> Port:
    return Port(torch.int32, vlen)


def port_f(vlen: int = 1) -> Port:
    return Port(torch.float32, vlen)


def port_c(vlen: int = 1) -> Port:
    return Port(torch.complex64, vlen)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Full signature of a block side: a tuple of Ports.

    Analog of gr_io_signature (min/max stream counts collapse to an exact
    tuple; variable-arity blocks expose factory parameters instead).
    """

    ports: Tuple[Port, ...]

    def __len__(self):
        return len(self.ports)

    def __getitem__(self, i):
        return self.ports[i]


class Block:
    """Base class for stream blocks.

    Subclasses set:
      * ``in_ports`` / ``out_ports``: sequences of :class:`Port`.
      * ``history``: input lookback in items (>= 1; 1 means none).  The
        executor delivers each input with ``history - 1`` leading items.
      * ``decim`` / ``interp``: fixed rate change — consume ``n`` (a multiple
        of ``decim``), produce ``n // decim * interp``.
      * ``variable_rate``: True for data-dependent production (clock
        recovery).  Such blocks return ``(y_padded, n_valid)`` where the
        valid items are a contiguous prefix of ``y_padded`` (length
        ``max_out_for(n_delivered)``) and ``n_valid`` is a 0-d int32 tensor.
        The executor compacts the valid items into a carried FIFO and runs
        the downstream blocks on fixed-size emissions drained from it (see
        StreamExecutor).

    and implement ``init_state()`` and ``apply(state, *inputs)``.
    """

    in_ports: Sequence[Port] = ()
    out_ports: Sequence[Port] = ()
    history: int = 1
    decim: int = 1
    interp: int = 1
    variable_rate: bool = False
    # Tag propagation policy, analog of gr_block.h:68-72 TPP_*.
    tag_propagation: str = "all_to_all"  # "dont" | "all_to_all" | "one_to_one"
    # True for blocks that *emit* tags during work (correlate_access_code_tag,
    # gr_burst_tagger).  Two mechanisms, in preference order:
    #   1. device_tags = True: the block implements apply_tagged(); the
    #      detection runs on the device and only a small fixed-size record
    #      (chunk-relative offsets + aux values) crosses to the host, where
    #      tags_from_device() turns it into Tag objects.  Under
    #      run(device_loop=True) the record is written into a static buffer
    #      of the captured step and read after the run.
    #   2. make_tags(): the executor captures the block's full in/out
    #      chunks each step and synthesizes tags on the host.
    # Propagation is host-plane either way (grtpu_torch.runtime.tags);
    # offsets stay exact because chunk sizes are static.  Emission is taken
    # from top-level blocks only (not behind a variable-rate block), as in
    # grtpu.
    emits_tags: bool = False
    device_tags: bool = False
    # Fixed per-chunk tag-record capacity for device_tags blocks (tags
    # beyond this in ONE chunk are dropped: the record's shape is static).
    max_tags_per_chunk: int = 128
    # True for a source block without carried state: the executor then
    # calls ``apply(state, n, device=...)``, since no state tensor tells the
    # block where to produce.
    source_takes_device: bool = False
    # True for a block whose work runs on the host (the Codec2 blocks' NumPy
    # codec): it reads its chunk back from the device, so a CUDA graph
    # cannot hold it, and ``run(device_loop=True)`` refuses its graph.
    host_only: bool = False

    _instance_counter = [0]
    # Bumped whenever ANY block's parameters change (see touch());
    # executors snapshot it to detect stale-parameter use.
    _global_version = [0]

    def __init__(self, name: str | None = None):
        Block._instance_counter[0] += 1
        self.uid = Block._instance_counter[0]
        self.name = name or f"{type(self).__name__}_{self.uid}"
        self.in_ports = tuple(self.in_ports)
        self.out_ports = tuple(self.out_ports)
        self._version = 0

    def touch(self):
        """Mark this block's parameters as changed.

        Parameter setters (set_taps, ...) call this.  A built StreamExecutor's
        ``step()`` raises if any of its blocks was touched after the build,
        so a retune never silently runs with the executor's old view of the
        flowgraph."""
        self._version += 1
        Block._global_version[0] += 1

    # -- contract -----------------------------------------------------------
    def init_state(self) -> Any:
        """Initial carried state: a tensor, a (Named)tuple of tensors, or
        ``()``."""
        return ()

    def apply(self, state, *inputs):
        """Process one time-block.

        Args:
          state: carried state from the previous call.
          *inputs: one tensor per input port, shaped ``(n + history - 1, [vlen])``.

        Returns:
          ``(new_state, outputs)`` with ``outputs`` a tuple of tensors, one
          per output port, each shaped ``(n // decim * interp, [vlen])``.
          Blocks with a single output may return the bare tensor.
        """
        raise NotImplementedError

    # -- introspection ------------------------------------------------------
    @property
    def relative_rate(self):
        """Output items per input item (gr_block.h:182-187).  For
        variable-rate blocks this is the *nominal* estimate."""
        if self.variable_rate:
            return self.nominal_rate
        return self.interp / self.decim

    @property
    def nominal_rate(self) -> float:
        """Expected output items per fresh input item.  Variable-rate blocks
        override (e.g. 1/sps for clock recovery); the executor sizes FIFO
        emissions from it."""
        return self.interp / self.decim

    def max_out_for(self, n_delivered: int) -> int:
        """Static bound on items produced from one delivered chunk of
        ``n_delivered`` items (including the ``history - 1`` halo).
        Variable-rate blocks MUST override this with the exact padded length
        their ``apply`` returns; production beyond it is deferred to the
        next chunk via the carried state."""
        return (n_delivered - (self.history - 1)) // self.decim * self.interp

    def make_tags(self, ins, outs, start_in: int, start_out: int):
        """Host-side tag synthesis for ``emits_tags`` blocks: called once
        per time-block with this block's input chunks (including the
        history halo) and output chunks as numpy arrays, plus the absolute
        stream offsets of the first fresh input/output item.  Returns a
        list of :class:`grtpu_torch.runtime.tags.Tag` with *output-stream*
        absolute offsets; the executor injects them onto the downstream
        edges (the analog of add_item_tag inside general_work)."""
        return []

    def apply_tagged(self, state, *inputs):
        """Work + tag detection on the device for ``device_tags`` blocks.

        Returns ``(new_state, outputs, tagrec)`` where ``tagrec`` is a dict
        of statically shaped tensors — by convention ``{"offset": int32
        (max_tags_per_chunk,), chunk-relative OUTPUT-stream offsets with -1
        marking unused rows, ...aux value tensors aligned with offset...}``.
        The executor reads the record on the host and calls
        :meth:`tags_from_device` to make the Tag objects."""
        raise NotImplementedError

    def tags_from_device(self, rec, start_in: int, start_out: int):
        """Turn one chunk's tag record (numpy arrays, as returned by
        apply_tagged) into a list of Tags with absolute offsets."""
        raise NotImplementedError

    def _tag_topk(self, hits: torch.Tensor, n: int):
        """Chunk-relative indices of up to ``max_tags_per_chunk`` True
        values of ``hits`` (length-n bool), ascending, padded with -1; and
        the matching gather indices (0 where unused).  ``torch.topk`` on a
        recency score ``n - i`` (unique for hits, 0 elsewhere): no
        data-dependent shape, so the step stays capturable."""
        k = min(self.max_tags_per_chunk, n)
        score = torch.where(hits, n - torch.arange(n, device=hits.device), 0)
        vals, idx = torch.topk(score, k)
        offs = torch.where(vals > 0, n - vals, -1).to(torch.int32)
        return offs, torch.where(vals > 0, idx, 0)

    def noutput_for(self, n_in: int) -> int:
        if n_in % self.decim:
            raise ValueError(
                f"{self.name}: input chunk {n_in} not a multiple of decim={self.decim}")
        return n_in // self.decim * self.interp

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
