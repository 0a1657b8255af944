"""``StreamExecutor.run(device_loop=True)``: the step from static buffers,
replayed from CUDA graphs.

grtpu runs every chunk of a finite input in one ``lax.scan`` dispatch.  The
port's counterpart keeps the executor's step and removes its host cost: the
step runs over buffers that live as long as the executor (the carried state,
one chunk of each input pad, the variable-rate FIFOs, the values that cross
from one piece of the step to the next, the emission rows), and on a CUDA
device each piece of it is captured once into a ``torch.cuda.CUDAGraph`` and
replayed for every later chunk.  A chunk then costs the host one copy in,
one replay a piece and one copy out a result.

Pieces.  A step is cut where the host must read the device: after each push
of a variable-rate block, whose ``n_valid`` decides how many emissions its
downstream segment drains.  Each segment (the top level, or one
variable-rate block's downstream blocks) is a list of ranges of blocks; a
range ends at a variable-rate block, whose padded output the piece writes
into the FIFO at a fill pointer kept on the device.  The host reads
``n_valid`` once a push, keeps the fill count, and replays the emission
piece (FIFO shift, the downstream blocks, the emission rows at a row index
kept on the device) once per full emission, as the eager executor's drain
does.  The results are bit-identical to calling ``step()`` once per chunk.

A piece's first call runs eagerly: it fills every cached constant (launch
plans, tap and bank matrices on the device, cuBLAS handles, cuFFT plans)
and sets the layout of the static buffers.  Its second call is captured and
then replayed.  On a CPU device no graph exists: each call runs the piece,
which exercises the same buffers.  On a CUDA device a capture that fails
raises; nothing falls back to the eager step.

Stream tags.  A top-level tag emitter's record (``apply_tagged``'s
statically shaped dict, or, for a ``make_tags`` block, its input and output
chunks) is one more static buffer that the captured piece writes; ``step``
returns a fresh copy of it among the captures, and the executor reads the
records of all chunks once the run has ended.

Launches of the hand kernels (``grtpu_torch.ops.cuda_fir.launches``) made
inside a capture are recorded with the graph and counted at every replay.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import torch

from grtpu_torch.runtime.executor import _edge_key, _leaves, _rebuild
from grtpu_torch.runtime.graph import Pad
from grtpu_torch.runtime.step_graph import StepGraph


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [_clone_tree(v) for v in tree])
    return tree


def _same_layout(old, new) -> bool:
    """Two state trees of the same structure and leaf shapes, dtypes and
    devices."""
    a, b = list(_leaves(old)), list(_leaves(new))
    return len(a) == len(b) and all(
        pa == pb and ta.shape == tb.shape and ta.dtype == tb.dtype
        and ta.device == tb.device for (pa, ta), (pb, tb) in zip(a, b))


def _commit(pairs):
    """Copy each new value into its static buffer.  A value that shares
    memory with any destination (a state leaf that is a view of another, an
    emission that is a view of its FIFO) is cloned before the first copy."""
    dsts = {d.untyped_storage().data_ptr() for d, _ in pairs}
    staged = []
    for dst, v in pairs:
        if v is dst:
            continue
        if v.untyped_storage().data_ptr() in dsts:
            v = v.clone()
        staged.append((dst, v))
    for dst, v in staged:
        dst.copy_(v)


@functools.lru_cache(maxsize=None)
def _is_capturing_fn():
    """``cudaStreamIsCapturing`` of the CUDA runtime torch loaded."""
    lib = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    fn = lib.cudaStreamIsCapturing
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _capture_invalidated() -> bool:
    """True once the capture on the current stream has been invalidated: an
    operation that a capture cannot hold ran, and CUDA said so only to the
    capture (the next launch then fails, wherever it is).  Asked after each
    block's apply while capturing, so that the error names the block that
    broke the capture."""
    status = ctypes.c_int(0)
    err = _is_capturing_fn()(torch.cuda.current_stream().cuda_stream,
                             ctypes.byref(status))
    return err == 0 and status.value == 2     # cudaStreamCaptureStatusInvalidated


class DeviceLoop:
    """The static buffers and the captured pieces of one executor's step."""

    def __init__(self, ex):
        self.ex = ex
        self.cuda = ex.device.type == "cuda"
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.cuda and ex.device.index is None else ex.device)
        self._vr = {v.uid: v for v in ex.vr_blocks}
        self.ranges: Dict[Optional[int], list] = {}
        self._range_of: Dict[int, int] = {}
        for okey in [None] + list(self._vr):
            blocks = ex._segment.get(okey, [])
            ranges, lo = [], 0
            for i, b in enumerate(blocks):
                self._range_of[b.uid] = len(ranges)
                if b.variable_rate:
                    ranges.append((lo, i + 1, b))
                    lo = i + 1
            if lo < len(blocks) or okey is not None:
                ranges.append((lo, len(blocks), None))
            self.ranges[okey] = ranges
        self.exports = {(okey, ri): self._exports(okey, ri)
                        for okey, ranges in self.ranges.items()
                        for ri in range(len(ranges))}
        dev = self.device
        # static buffers
        self.blocks: Dict[str, object] = {}
        self.tails: Dict[str, torch.Tensor] = {}
        self.fifo: Dict[str, tuple] = {}
        self.fill: Dict[str, int] = {}                  # host fill counts
        self.fill_dev = {v.name: torch.zeros((), dtype=torch.int64, device=dev)
                         for v in ex.vr_blocks}
        self.nvalid = {v.name: torch.zeros((), dtype=torch.int64, device=dev)
                       for v in ex.vr_blocks}
        self.ecnt = {v.name: torch.zeros((), dtype=torch.int64, device=dev)
                     for v in ex.vr_blocks}
        self.emit = {key: torch.zeros((rows,) + port.chunk_shape(items),
                                      dtype=port.dtype, device=dev)
                     for key, (rows, items, port, _o) in ex._emit_specs.items()}
        self.inputs: Optional[tuple] = None
        self.edges: Dict[str, torch.Tensor] = {}
        self.caps: Dict[str, tuple] = {}
        self.tagcaps: Dict[str, object] = {}     # tag records, by caps key
        self.pieces: Dict[tuple, StepGraph] = {}
        self.current = None          # the block a piece is applying
        self.failure = None          # the first error raised inside a piece
        self.capture_seconds = 0.0   # host time spent capturing the graphs

    def graphs(self) -> Dict[tuple, "torch.cuda.CUDAGraph"]:
        """The captured graphs, by (segment, range): the segment None is
        the top level, else a variable-rate block's uid."""
        return {k: p.graph for k, p in self.pieces.items()
                if p.graph is not None}

    # ------------------------------------------------------------ structure
    def _exports(self, okey, ri) -> List[str]:
        """Edge values made in range ``ri`` of segment ``okey`` that a later
        range of the segment, or an output pad read after the step, needs."""
        ex = self.ex
        ranges = self.ranges[okey]
        lo, hi, _ = ranges[ri]
        last = ri == len(ranges) - 1
        edges = []
        for b in ex._segment.get(okey, [])[lo:hi]:
            if not b.variable_rate:
                edges += ex._downs[b.uid]
        if okey is not None and ri == 0:
            edges += ex._downs[okey]          # the emission, read from the FIFO
        keys = []
        for e in edges:
            dst = e.dst.block
            if isinstance(dst, Pad):
                if okey is None or not last:
                    keys.append(_edge_key(e))
            elif self._range_of[dst.uid] > ri:
                keys.append(_edge_key(e))
        return keys

    # ------------------------------------------------------------ state
    def load(self, state):
        """Copy the executor's state into the static buffers; returns the
        per-chunk step.  A state whose layout differs from the buffers'
        (possible only before the first run) re-allocates them and drops
        every captured piece."""
        fresh = False
        for store, part in ((self.blocks, state["blocks"]),
                            (self.tails, state["tails"])):
            for k, tree in part.items():
                if k in store and _same_layout(store[k], tree):
                    _commit(list(zip(self._leaf_list(store[k]),
                                     self._leaf_list(tree))))
                else:
                    store[k] = _clone_tree(tree)
                    fresh = True
        for name, (bufs, fill) in state["fifo"].items():
            if name in self.fifo and _same_layout(self.fifo[name], bufs):
                _commit(list(zip(self.fifo[name], bufs)))
            else:
                self.fifo[name] = _clone_tree(tuple(bufs))
                fresh = True
            self.fill[name] = int(fill)
            self.fill_dev[name].fill_(self.fill[name])
        if fresh:
            self.pieces = {}
        return self.step

    @staticmethod
    def _leaf_list(tree):
        return [t for _, t in _leaves(tree)]

    def unload(self):
        """The executor state, as fresh tensors."""
        return {"blocks": {k: _clone_tree(v) for k, v in self.blocks.items()},
                "tails": {k: v.clone() for k, v in self.tails.items()},
                "fifo": {name: (_clone_tree(bufs),
                                torch.tensor(self.fill[name], dtype=torch.int32))
                         for name, bufs in self.fifo.items()}}

    # ------------------------------------------------------------ step
    def step(self, *chunk):
        """One time-block: ``(pads, caps)`` as ``StreamExecutor.step``
        returns them, each a fresh tensor."""
        if self.inputs is None:
            self.inputs = tuple(torch.empty_like(x) for x in chunk)
        for buf, x in zip(self.inputs, chunk):
            buf.copy_(x)
        counts = {v.name: 0 for v in self.ex.vr_blocks}
        if self.cuda:
            with torch.cuda.device(self.device):
                self._drive(None, counts)
        else:
            self._drive(None, counts)
        return self._outputs(counts)

    def _drive(self, okey, counts):
        ex = self.ex
        for ri, (_lo, _hi, push) in enumerate(self.ranges[okey]):
            self._run((okey, ri))
            if push is None:
                continue
            name, n_emit = push.name, ex.vr_emit[push.uid]
            self.fill[name] += int(self.nvalid[name])   # the push's one read
            while self.fill[name] >= n_emit:
                if counts[name] >= ex.vr_total_rows[push.uid]:
                    raise ValueError(f"{name}: more emissions in one step than "
                                     f"its emission buffers hold")
                self._drive(push.uid, counts)
                self.fill[name] -= n_emit
                counts[name] += 1

    def _outputs(self, counts):
        ex = self.ex
        pads = []
        for i, e in enumerate(ex.out_pad_edges):
            src = e.src.block
            if i in ex._pad_emit_key:
                pads.append(self.emit[ex._pad_emit_key[i]].clone())
            elif isinstance(src, Pad):
                pads.append(self.inputs[src.index].clone())
            else:
                pads.append(self.edges[_edge_key(e)].clone())
        caps = {name: tuple(v.clone() for v in vals)
                for name, vals in self.caps.items()}
        caps.update((k, _clone_tree(v)) for k, v in self.tagcaps.items())
        if ex.vr_blocks:
            for name, keys in ex._vr_sink_keys.items():
                caps[name] = tuple(self.emit[k].clone() for k in keys)
            caps["__vr_counts__"] = counts
        return tuple(pads), caps

    # ------------------------------------------------------------ pieces
    def _run(self, key):
        p = self.pieces.get(key)
        if p is None:
            fn = self._piece(*key)
            p = self.pieces[key] = StepGraph(None, self.device)
            # the piece's argument: whether this is its first call
            p.step = lambda: fn(p.calls == 0)
        if p.cuda and p.calls and p.graph is None:
            self._capture(p)
        p()

    def _capture(self, p):
        self.current = self.failure = None
        try:
            p.capture()
        except Exception as err:
            first = self.failure or err
            where = ("" if self.current is None
                     else f" in {self.current.name}.apply")
            raise RuntimeError(
                f"device_loop: capturing the step into a CUDA graph failed"
                f"{where}: {type(first).__name__}: {first}.  A captured step "
                f"cannot read the card from the host (.item(), int(tensor), "
                f"a shape that depends on data) or copy host memory to it; "
                f"run this graph without device_loop") from err
        self.capture_seconds += p.capture_seconds

    def _piece(self, okey, ri):
        """The function of range ``ri`` of segment ``okey``: reads and
        writes the static buffers only.  Its argument says whether this is
        the first call, which may set the buffers' layout."""
        ex = self.ex
        owner = self._vr.get(okey)
        ranges = self.ranges[okey]
        lo, hi, push = ranges[ri]
        blocks = ex._segment.get(okey, [])[lo:hi]
        first, last = ri == 0, ri == len(ranges) - 1
        exports = self.exports[(okey, ri)]
        pad_rows = [] if owner is None or not last else [
            (ex._pad_emit_key[i], _edge_key(e))
            for i, e in enumerate(ex.out_pad_edges)
            if i in ex._pad_emit_key
            and ex._emit_specs[ex._pad_emit_key[i]][3] is owner]
        sink_rows = {}
        if owner is not None:
            for b in blocks:
                if not b.out_ports and b.in_ports:
                    sink_rows[b.name] = [ex._sink_emit_key[(b.name, j)]
                                         for j in range(len(b.in_ports))]

        def fn(settle: bool):
            capturing = self.cuda and not settle
            pairs = []
            ctx = {"blocks": dict(self.blocks), "tails": dict(self.tails)}
            edge_vals = dict(self.edges)
            if okey is None and first:
                for c in self.ecnt.values():
                    c.zero_()
            if owner is not None and first:
                n_emit = ex.vr_emit[okey]
                bufs = self.fifo[owner.name]
                xs = [buf[:n_emit] for buf in bufs]
                for e in ex._downs[okey]:
                    edge_vals[_edge_key(e)] = xs[e.src.port]
                pairs += [(buf, torch.cat([buf[n_emit:],
                                           buf.new_zeros(buf[:n_emit].shape)]))
                          for buf in bufs]
                self.fill_dev[owner.name].sub_(n_emit)
            try:
                for b in blocks:
                    self.current = b
                    ins, outs, rec = ex._apply_block(b, ctx, edge_vals,
                                                     self.inputs)
                    if capturing and _capture_invalidated():
                        raise RuntimeError(
                            "an operation the capture cannot hold ran here "
                            "(CUDA invalidated the capture without an error)")
                    if b is push:
                        pairs += self._push(b, outs)
                        continue
                    outs = ex._fixed_outputs(b, outs)
                    if rec is not None:
                        pairs += self._settle(self.tagcaps, "__tagdev__" + b.name,
                                              rec, settle, b.name)
                    elif b.emits_tags and owner is None:
                        pairs += self._settle(self.tagcaps, "__tagsrc__" + b.name,
                                              (tuple(ins), tuple(outs)),
                                              settle, b.name)
                    if not b.out_ports and ins:
                        if owner is None:
                            pairs += self._settle(self.caps, b.name,
                                                  tuple(ins), settle, b.name)
                        else:
                            row = self.ecnt[owner.name].view(1)
                            for key, v in zip(sink_rows[b.name], ins):
                                self._write_row(key, row, v)
                    for e in ex._downs[b.uid]:
                        edge_vals[_edge_key(e)] = outs[e.src.port]
            except Exception as err:
                self.failure = self.failure or err
                raise
            self.current = None
            if owner is not None and last:
                row = self.ecnt[owner.name].view(1)
                for key, k in pad_rows:
                    self._write_row(key, row, edge_vals[k])
                self.ecnt[owner.name].add_(1)
            for b in blocks:
                uid = str(b.uid)
                pairs += self._settle(self.blocks, uid, ctx["blocks"][uid],
                                      settle, b.name)
                if b.history > 1:
                    for e in ex._ups[b.uid].values():
                        k = _edge_key(e)
                        pairs += self._settle(self.tails, k, ctx["tails"][k],
                                              settle, b.name)
            for k in exports:
                pairs += self._settle(self.edges, k, edge_vals[k], settle, k)
            _commit(pairs)

        return fn

    def _push(self, v, outs):
        """Write a variable-rate block's padded output into its FIFO at the
        device fill pointer, advance the pointer by n_valid and keep n_valid
        for the host's read."""
        ex = self.ex
        ys, n_valid = ex._vr_outputs(v, outs)
        n_pad = ys[0].shape[0]
        if n_pad > ex.vr_maxout[v.uid]:
            raise ValueError(
                f"{v.name}: variable-rate apply returned {n_pad} items, more "
                f"than max_out_for gives ({ex.vr_maxout[v.uid]})")
        fill = self.fill_dev[v.name]
        idx = fill + torch.arange(n_pad, device=self.device)
        pairs = [(buf, buf.index_copy(0, idx, y.to(buf.dtype)))
                 for buf, y in zip(self.fifo[v.name], ys)]
        n_valid = torch.as_tensor(n_valid, device=self.device)
        self.nvalid[v.name].copy_(n_valid)
        fill.add_(n_valid)
        return pairs

    def _settle(self, store, key, value, settle, who):
        """(static buffer, value) pairs for one state tree or edge value;
        on a piece's first call a missing buffer, or one of another layout,
        is made from the value."""
        old = store.get(key)
        if old is not None and _same_layout(old, value):
            return list(zip(self._leaf_list(old), self._leaf_list(value)))
        if not settle:
            raise ValueError(
                f"device_loop: {who}: a value the step carries changed its "
                f"shape, dtype or structure from one step to the next")
        store[key] = _clone_tree(value)
        return []

    def _write_row(self, key, row, v):
        buf = self.emit[key]
        buf.index_copy_(0, row, v[None].to(buf.dtype))
