"""Time-block stream executor over torch tensors.

Port of ``grtpu.runtime.executor.StreamExecutor``.  A flowgraph runs over
fixed-size time-blocks (chunks): every edge's per-step item count is fixed
by static rate propagation before the first step, each input carries the
last ``history - 1`` items of the previous chunk (the halo tails, carried
state), and the blocks run eagerly in topological order on one
``torch.device``.

Variable-rate blocks (clock recovery) are first-class graph citizens, as in
grtpu: such a block returns ``(y_padded, n_valid)`` with the valid items a
contiguous prefix.  The executor writes the padded output into a carried
FIFO of capacity ``n_emit - 1 + max_out`` at the fill pointer, advances the
pointer by ``n_valid``, and drains fixed-size ``n_emit`` *emissions* through
the block's downstream segment, so downstream blocks always see exactly
``n_emit`` items.  grtpu's ``lax.while_loop`` drain becomes a Python loop:
the occupancy is host state, and reading ``n_valid`` is the one device sync
of each push.  Outputs behind a variable-rate boundary surface from
``step`` as ``(max_emissions, n, ...)`` emission buffers plus a per-step
emission count (``caps["__vr_counts__"]``); ``run``/``stream`` compact them.

The executor state is a dict of tensors:
``{"blocks": {uid: block state}, "tails": {edge: halo},
"fifo": {vr block: ((buffer, ...), fill)}}`` — buffers on the executor's
device, the fill count a host (CPU) int32 tensor.  Checkpoints use grtpu's
own npz format (``arr_j`` arrays under canonical, topology-relative
``__paths__``), so a flowgraph checkpointed by grtpu resumes here, and the
reverse.

``run(..., device_loop=True)`` runs the same step from static buffers and,
on a CUDA device, replays it from CUDA graphs (:mod:`grtpu_torch.runtime.
device_loop`); ``fuse_firs`` composes adjacent FIR filters before the
topology is computed (:mod:`grtpu_torch.runtime.optimize`); ``debug_taps``
keeps every top-level edge's stream in :attr:`StreamExecutor.edge_data`.

Stream tags ride on the host, as in grtpu: ``add_tags`` puts tags on an
input pad's stream, tag-emitting blocks (``make_tags`` / ``device_tags``)
add theirs each time-block, and a precomputed tag plan moves them block by
block once a chunk, scaling offsets by each block's rate and keeping what
reaches a sink (:attr:`StreamExecutor.sink_tags`) or an output pad
(:attr:`StreamExecutor.pad_tags`).  ``step`` advances the plan after its
chunk; ``run(device_loop=True)`` keeps each chunk's tag records on the
device and replays the plan chunk by chunk once the run has ended, so that
tags add no host read inside the run.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from grtpu_torch.runtime.block import Block
from grtpu_torch.runtime.graph import Edge, FlatGraph, Graph, Pad
from grtpu_torch.runtime.tags import Tag, propagate_tags
from grtpu_torch.utils.device import resolve
from grtpu_torch.utils.trace import span


def _edge_key(e: Edge) -> str:
    return f"{e.src.block.name}.{e.src.port}->{e.dst.block.name}.{e.dst.port}"


class _AttrKey(str):
    """A NamedTuple field in a state path.  grtpu's canonical checkpoint
    paths spell such a key ``None`` (jax's attribute key has neither
    ``.key`` nor ``.idx``), so a field's path is its block's path plus
    ``/None``; the fields keep their declaration order."""


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _rebuild(tree, items):
    return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(items)


def _tree_to(tree, device):
    """Move every tensor of a state tree (tensor / (named)tuple / list /
    dict)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [_tree_to(v, device) for v in tree])
    return tree


def _leaves(tree, path=()):
    """(path, tensor) for every tensor of a state tree: dict keys, sequence
    indices and NamedTuple fields (as :class:`_AttrKey`) as path parts."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, path + (_AttrKey(f),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        raise TypeError(f"state leaves must be tensors, got {type(tree)}")


def _replace_leaves(tree, new, path=()):
    """A copy of ``tree`` with each tensor replaced by ``new[path]``."""
    if isinstance(tree, torch.Tensor):
        return new[path]
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, new, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return _rebuild(tree, [_replace_leaves(v, new, path + (_AttrKey(f),))
                               for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [_replace_leaves(v, new, path + (str(i),))
                               for i, v in enumerate(tree)])
    return tree


class _TagPlane:
    """Host-side tag state for one stream: per-edge tag queues, the set of
    edges with tags in flight, and the terminal stores (sink and pad
    tags)."""

    __slots__ = ("tags", "tagged", "sink_tags", "pad_tags")

    def __init__(self, edge_keys):
        self.tags: Dict[str, List[Tag]] = {k: [] for k in edge_keys}
        self.tagged: set = set()
        self.sink_tags: Dict[str, List[Tag]] = {}
        self.pad_tags: Dict[int, List[Tag]] = {}


def _to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class _RateMismatch(ValueError):
    """A join's inputs disagree; carries (source_root, have, need)
    rescale candidates for the demand-balancing retry loop."""

    def __init__(self, msg, candidates):
        super().__init__(msg)
        self.candidates = candidates


class StreamExecutor:
    """Run a flowgraph over fixed-size time-blocks on one torch device.

    Args:
      graph: a :class:`Graph` (flattened automatically) or :class:`FlatGraph`.
      chunk_size: items produced per step by each root (input pad or source
        block).  Must be a multiple of every decimation chain; use
        :meth:`required_multiple` to query.  ``None`` picks the smallest
        valid size >= 4096.
      root_chunks: optional per-root overrides ``{pad_or_block: n}``.
      vr_chunks: optional per-variable-rate-block emission size overrides
        ``{block: n_emit}`` (default: the expected per-step production,
        snapped to the downstream segment's decimation multiple).
      device: the torch device that holds the state and runs every block;
        the card (``cuda``) when not given.
        Host inputs are moved there at ``run``/``step`` entry.
      debug_taps: keep every top-level edge's stream of every step in
        :attr:`edge_data` (write them out with :meth:`dump_debug_taps`).
      fuse_firs: collapse chains of adjacent FirFilter blocks into composed
        filters before the rates are computed.
    """

    def __init__(
        self,
        graph: Graph | FlatGraph,
        chunk_size: Optional[int] = 4096,
        root_chunks: Optional[Dict[Any, int]] = None,
        vr_chunks: Optional[Dict[Any, int]] = None,
        device=None,
        debug_taps: bool = False,
        fuse_firs: bool = False,
    ):
        self.flat = graph.flatten() if isinstance(graph, Graph) else graph
        if fuse_firs:
            from grtpu_torch.runtime.optimize import fuse_fir_chains

            self.flat = fuse_fir_chains(self.flat)
        self.order = self.flat.topological_order()
        self.debug_taps = debug_taps
        self.edge_data: Dict[str, List[torch.Tensor]] = {}
        self.device = resolve(device)
        self._ups = {b.uid: self.flat.upstream_of(b) for b in self.order}
        self._downs = {b.uid: self.flat.downstream_of(b) for b in self.order}
        self._compute_topology()
        if chunk_size is None:
            m = self.required_multiple()
            chunk_size = -(-4096 // m) * m
        self.chunk_size = int(chunk_size)
        root_chunks = dict(root_chunks or {})
        # demand balancing: a join whose branches come from different SOURCE
        # roots determines each root's per-step production; retry rate
        # propagation, scaling source roots until all joins agree
        for _ in range(32):
            try:
                self._compute_rates(root_chunks, vr_chunks or {})
                break
            except _RateMismatch as e:
                fixed = False
                for src_block, have, need in e.candidates:
                    if need % have == 0:
                        cur = root_chunks.get(src_block, self.chunk_size)
                        root_chunks[src_block] = cur * (need // have)
                        fixed = True
                        break
                if not fixed:
                    raise ValueError(str(e)) from None
        else:
            raise ValueError("could not balance source rates")
        self._build_emit_specs()
        self.state = self._make_state()
        self.sink_data: Dict[str, tuple] = {}
        self._device_loop = None  # run(device_loop=True)'s static buffers
        # host-side stream tags: one plane, absolute item counters a block
        self._plane = _TagPlane(self._edge_keys)
        self._tags: Dict[str, List[Tag]] = self._plane.tags
        self.sink_tags: Dict[str, List[Tag]] = self._plane.sink_tags
        self.pad_tags: Dict[int, List[Tag]] = self._plane.pad_tags
        self.nitems = {b.name: 0 for b in self.order}      # items consumed
        self.nitems_out = {b.name: 0 for b in self.order}  # items produced
        self._build_tag_plan()
        # Stale-parameter guard: snapshot block versions; step() raises if
        # a setter touched a block after this executor was built.
        self._global_version_snap = Block._global_version[0]
        self._block_versions = {b.uid: b._version for b in self.order}

    def _check_versions(self):
        """Raise if any block parameter changed after this executor was
        built.  O(1) in the common case via the class-wide version counter."""
        if Block._global_version[0] == self._global_version_snap:
            return
        stale = [b.name for b in self.order
                 if b._version != self._block_versions[b.uid]]
        if stale:
            raise RuntimeError(
                f"block parameters changed after the executor was built "
                f"({', '.join(stale)}); rebuild the executor")
        # someone touched a block outside this graph; resnapshot so the
        # fast path stays O(1)
        self._global_version_snap = Block._global_version[0]

    # ------------------------------------------------------------------ rates
    def _compute_topology(self):
        """Ownership/depth topology: which variable-rate block's drain loop
        each block runs in (None = top level)."""
        self.block_owner: Dict[int, Optional[Block]] = {}
        self.block_depth: Dict[int, int] = {}
        self.vr_blocks: List[Block] = []
        for b in self.order:
            ups = self._ups[b.uid]
            if not ups:
                owner, depth = None, 0
            else:
                owners, depths = set(), set()
                for e in ups.values():
                    src = e.src.block
                    if isinstance(src, Pad):
                        owners.add(None)
                        depths.add(0)
                    elif src.variable_rate:
                        owners.add(src)
                        depths.add(self.block_depth[src.uid] + 1)
                    else:
                        owners.add(self.block_owner[src.uid])
                        depths.add(self.block_depth[src.uid])
                if len(owners) != 1 or len(depths) != 1:
                    raise ValueError(
                        f"{b.name}: inputs join streams from different "
                        f"variable-rate domains; such joins cannot be "
                        f"rate-aligned")
                owner, depth = owners.pop(), depths.pop()
            self.block_owner[b.uid] = owner
            self.block_depth[b.uid] = depth
            if b.variable_rate:
                self.vr_blocks.append(b)
        # each segment's blocks, in topological order
        self._segment: Dict[Optional[int], List[Block]] = {}
        for b in self.order:
            o = self.block_owner[b.uid]
            self._segment.setdefault(None if o is None else o.uid, []).append(b)

    def _compute_rates(self, root_chunks, vr_chunks):
        """Static rate propagation, replacing gr_block::forecast(): every
        edge gets a per-step item count, every block its per-step input
        count n_in (gr_flat_flowgraph.cc:89-122, exactly).  Blocks behind a
        variable-rate block get per-*emission* counts, from that block's
        emission size."""
        self.edge_items: Dict[str, int] = {}
        self.block_nin: Dict[int, int] = {}
        pad_chunk = {id(pad): int(root_chunks.get(pad, self.chunk_size))
                     for pad in self.flat.in_pads}
        self._pad_chunk = pad_chunk
        self.vr_emit: Dict[int, int] = {}     # vr uid -> items per emission
        self.vr_maxout: Dict[int, int] = {}   # vr uid -> padded apply output
        self.vr_cap: Dict[int, int] = {}      # vr uid -> fifo capacity
        self.vr_emax: Dict[int, int] = {}     # vr uid -> per-step emission bound
        for b in self.order:
            ups = self._ups[b.uid]
            if not ups:  # source block
                n_in = int(root_chunks.get(b, self.chunk_size)) * b.decim // b.interp
            else:
                counts = {}
                for i, e in ups.items():
                    src = e.src.block
                    counts[i] = (pad_chunk[id(src)] if isinstance(src, Pad)
                                 else self.edge_items[_edge_key(e)])
                if len(set(counts.values())) != 1:
                    need = math.lcm(*counts.values())
                    cands = []
                    for i, c in counts.items():
                        if c == need:
                            continue
                        root = self._source_root_of(ups[i])
                        if root is not None:
                            cands.append((root, c, need))
                    raise _RateMismatch(
                        f"{b.name}: input ports receive unequal chunk sizes "
                        f"{sorted(set(counts.values()))}; insert "
                        f"rate-matching blocks or rescale the sources",
                        cands)
                n_in = next(iter(counts.values()))
            if n_in % b.decim:
                raise ValueError(
                    f"{b.name}: per-step input {n_in} not divisible by "
                    f"decim={b.decim}; pick chunk_size a multiple of "
                    f"{self.required_multiple()}")
            self.block_nin[b.uid] = n_in
            if b.variable_rate:
                max_out = int(b.max_out_for(n_in + b.history - 1))
                sub_mult = self._segment_multiple(b)
                if b in vr_chunks:
                    n_emit = int(vr_chunks[b])
                    if n_emit % sub_mult:
                        raise ValueError(
                            f"{b.name}: vr_chunks emission size {n_emit} not "
                            f"a multiple of downstream requirement {sub_mult}")
                else:
                    expected = n_in * float(b.nominal_rate)
                    n_emit = max(sub_mult,
                                 int(expected // sub_mult) * sub_mult)
                cap = n_emit - 1 + max_out
                self.vr_emit[b.uid] = n_emit
                self.vr_maxout[b.uid] = max_out
                self.vr_cap[b.uid] = cap
                self.vr_emax[b.uid] = cap // n_emit
                n_out = n_emit
            else:
                n_out = n_in // b.decim * b.interp
            for e in self._downs[b.uid]:
                self.edge_items[_edge_key(e)] = n_out

        # emission-buffer rows for a segment = product of the emission
        # bounds down the owner chain (nested drains multiply)
        self.vr_total_rows: Dict[int, int] = {}
        for v in self.vr_blocks:
            rows = self.vr_emax[v.uid]
            o = self.block_owner[v.uid]
            while o is not None:
                rows *= self.vr_emax[o.uid]
                o = self.block_owner[o.uid]
            self.vr_total_rows[v.uid] = rows

        self.out_pad_edges: List[Edge] = []
        for pad in self.flat.out_pads:
            feed = [e for e in self.flat.edges if e.dst.block is pad]
            if len(feed) != 1:
                raise ValueError(f"output pad {pad.name} must have exactly one driver")
            self.out_pad_edges.append(feed[0])
        self._edge_keys = [_edge_key(e) for e in self.flat.edges
                           if isinstance(e.dst.block, Block)]

    def _source_root_of(self, e: Edge) -> Optional[Block]:
        """The unique SOURCE block feeding this edge's path, if any — the
        block whose per-step production the demand balancer may rescale.
        None if the path starts at an input pad or mixes several roots."""
        src = e.src.block
        if isinstance(src, Pad):
            return None
        ups = self._ups[src.uid]
        if not ups:
            return src
        roots = {self._source_root_of(up) for up in ups.values()}
        return roots.pop() if len(roots) == 1 else None

    def _edge_owner(self, e: Edge) -> Optional[Block]:
        src = e.src.block
        if isinstance(src, Pad):
            return None
        if src.variable_rate:
            return src
        return self.block_owner[src.uid]

    def _segment_multiple(self, owner: Optional[Block]) -> int:
        """Chunk-size divisibility requirement of the blocks directly owned
        by ``owner`` (None = the top-level segment): for input count C*r (r
        the cumulative rate fraction) to be a positive multiple of decim, C
        must be a multiple of decim*den(r)/gcd(num(r), decim*den(r))."""
        mult = 1
        rate_to: Dict[int, Fraction] = {}
        for b in self.order:
            if self.block_owner[b.uid] is not owner:
                continue
            rs = set()
            for e in self._ups[b.uid].values():
                s = e.src.block
                if isinstance(s, Pad) or s.variable_rate:
                    rs.add(Fraction(1))
                elif s.uid in rate_to:
                    rs.add(rate_to[s.uid])
            r = rs.pop() if rs else Fraction(1)
            need = (b.decim * r.denominator) // math.gcd(
                r.numerator, b.decim * r.denominator)
            mult = math.lcm(mult, need)
            rate_to[b.uid] = r * Fraction(b.interp, b.decim)
        return mult

    def required_multiple(self) -> int:
        """Exact chunk-size divisibility requirement of the top-level
        segment (segments behind a variable-rate boundary constrain the
        executor-chosen emission size instead)."""
        return self._segment_multiple(None)

    def _build_emit_specs(self):
        """Emission buffers: pads and sink inputs fed from inside a VR
        segment surface as (rows, items, ...) buffers + a per-VR count."""
        specs: Dict[str, tuple] = {}  # key -> (rows, items, port, owner)
        self._pad_emit_key: Dict[int, str] = {}
        self._sink_emit_key: Dict[tuple, str] = {}
        self._vr_sink_keys: Dict[str, List[str]] = {}  # sink -> port keys
        for i, e in enumerate(self.out_pad_edges):
            o = self._edge_owner(e)
            if o is not None:
                key = f"pad{i}"
                specs[key] = (self.vr_total_rows[o.uid],
                              self.edge_items[_edge_key(e)],
                              self.flat.out_pads[i].port, o)
                self._pad_emit_key[i] = key
        for b in self.order:
            o = self.block_owner[b.uid]
            if b.out_ports or not b.in_ports or o is None:
                continue
            for j, e in self._ups[b.uid].items():
                key = f"sink:{b.name}:{j}"
                specs[key] = (self.vr_total_rows[o.uid],
                              self.edge_items[_edge_key(e)], b.in_ports[j], o)
                self._sink_emit_key[(b.name, j)] = key
                self._vr_sink_keys.setdefault(b.name, []).append(key)
        self._emit_specs = specs

    # ------------------------------------------------------------------ state
    def _make_state(self):
        """The initial state dict: block states, halo tails and VR FIFOs on
        the executor's device, each FIFO's fill count on the host."""
        blocks = {str(b.uid): _tree_to(b.init_state(), self.device)
                  for b in self.order}
        tails = {}
        for b in self.order:
            if b.history > 1:
                for i, e in self._ups[b.uid].items():
                    port = b.in_ports[i]
                    tails[_edge_key(e)] = torch.zeros(
                        port.chunk_shape(b.history - 1), dtype=port.dtype,
                        device=self.device)
        fifos = {}
        for v in self.vr_blocks:
            bufs = tuple(torch.zeros(port.chunk_shape(self.vr_cap[v.uid]),
                                     dtype=port.dtype, device=self.device)
                         for port in v.out_ports)
            fifos[v.name] = (bufs, torch.zeros((), dtype=torch.int32))
        return {"blocks": blocks, "tails": tails, "fifo": fifos}

    def _ingest(self, x, pad: Pad) -> torch.Tensor:
        """Host or device input -> a tensor of the pad's dtype on the
        executor's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=pad.port.dtype)

    # ------------------------------------------------------------------ step
    def _tags_on_device(self, b: Block) -> bool:
        """b detects its tags on the device (``apply_tagged``): a top-level
        ``device_tags`` emitter."""
        return (b.emits_tags and b.device_tags
                and self.block_owner[b.uid] is None)

    def _apply_block(self, b: Block, ctx, edge_vals, ext_inputs, mark=None):
        """Gather b's inputs (each with its halo tail prepended, the tail
        advanced in ``ctx``), apply b and keep its new state in ``ctx``.
        Returns (inputs, raw apply outputs, tag record or None).  ``mark``,
        where given, is called with the owner of the work issued since its
        last call: ``"executor"`` before ``b.apply`` and b's name after it
        (``device_loop`` counts a capture's nodes by block with it)."""
        ups = self._ups[b.uid]
        ins = []
        for i in range(len(b.in_ports)):
            e = ups[i]
            src = e.src.block
            v = (ext_inputs[src.index] if isinstance(src, Pad)
                 else edge_vals[_edge_key(e)])
            if b.history > 1:
                k = _edge_key(e)
                full = torch.cat([ctx["tails"][k], v], dim=0)
                ctx["tails"][k] = full[full.shape[0] - (b.history - 1):]
                v = full
            ins.append(v)
        uid = str(b.uid)
        rec = None
        if mark is not None:
            mark("executor")
        with span(f"grtpu.block:{b.name}"):
            if not b.in_ports:
                n_out = self.block_nin[b.uid] // b.decim * b.interp
                if b.source_takes_device:
                    new_s, outs = b.apply(ctx["blocks"][uid], n_out,
                                          device=self.device)
                else:
                    new_s, outs = b.apply(ctx["blocks"][uid], n_out)
            elif self._tags_on_device(b):
                new_s, outs, rec = b.apply_tagged(ctx["blocks"][uid], *ins)
                rec = dict(rec)
            else:
                new_s, outs = b.apply(ctx["blocks"][uid], *ins)
        if mark is not None:
            mark(b.name)
        ctx["blocks"][uid] = new_s
        return ins, outs, rec

    @staticmethod
    def _fixed_outputs(b: Block, outs) -> tuple:
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(b.out_ports):
            raise ValueError(
                f"{b.name}: apply returned {len(outs)} outputs, "
                f"declared {len(b.out_ports)} ports")
        return tuple(outs)

    @staticmethod
    def _vr_outputs(v: Block, outs):
        """A variable-rate apply's (y_padded, n_valid) as (ys tuple,
        n_valid)."""
        if not (isinstance(outs, (tuple, list)) and len(outs) == 2):
            raise ValueError(
                f"{v.name}: variable-rate apply must return "
                f"(state, (y_padded, n_valid))")
        ys, n_valid = outs
        if not isinstance(ys, (tuple, list)):
            ys = (ys,)
        if len(ys) != len(v.out_ports):
            raise ValueError(
                f"{v.name}: variable-rate apply returned {len(ys)} "
                f"padded outputs, declared {len(v.out_ports)} ports")
        return tuple(ys), n_valid

    def _run_segment(self, owner: Optional[Block], ctx, edge_vals,
                     ext_inputs, caps):
        """Run the blocks owned by ``owner`` in topological order over one
        time-block (owner None) or one emission, updating ``ctx`` (block
        states, tails, FIFOs, emission buffers and counts) in place.
        ``edge_vals`` holds this segment's edge values."""
        for b in self._segment.get(None if owner is None else owner.uid, ()):
            ins, outs, rec = self._apply_block(b, ctx, edge_vals, ext_inputs)
            if b.variable_rate:
                self._push_and_drain(b, ctx, self._vr_outputs(b, outs),
                                     ext_inputs, caps)
                continue
            outs = self._fixed_outputs(b, outs)
            if rec is not None:
                caps["__tagdev__" + b.name] = rec
            elif b.emits_tags and owner is None:
                # host-side tag synthesis (make_tags): this block's full
                # in/out chunks
                caps["__tagsrc__" + b.name] = (tuple(ins), tuple(outs))
            if not b.out_ports and ins:
                if owner is None:
                    caps[b.name] = tuple(ins)
                else:
                    # each captured input is one emission row
                    row = ctx["ecnt"][owner.name]
                    for j, v in enumerate(ins):
                        ctx["emit"][self._sink_emit_key[(b.name, j)]][row] = v
            for e in self._downs[b.uid]:
                edge_vals[_edge_key(e)] = outs[e.src.port]
        return edge_vals

    def _push_and_drain(self, v: Block, ctx, vr_out, ext_inputs, caps):
        """Write v's padded output into its FIFO at the fill pointer and
        advance the pointer by n_valid (valid items are a contiguous
        prefix, so the padding past them is overwritten by the next push),
        then drain full n_emit emissions through v's downstream segment.
        Multi-output VR blocks keep one buffer per port, advancing in
        lockstep on a shared count."""
        n_emit = self.vr_emit[v.uid]
        ys, n_valid = vr_out
        bufs, fill_t = ctx["fifo"][v.name]
        fill = int(fill_t)
        n_pad = ys[0].shape[0]
        if fill + n_pad > self.vr_cap[v.uid]:
            raise ValueError(
                f"{v.name}: variable-rate apply returned {n_pad} items, more "
                f"than max_out_for gives ({self.vr_maxout[v.uid]})")
        bufs = tuple(torch.cat([buf[:fill], y.to(buf.dtype), buf[fill + n_pad:]])
                     for buf, y in zip(bufs, ys))
        with span(f"grtpu.push_read:{v.name}"):
            fill += int(n_valid)  # the push's one device -> host read
        down = self._downs[v.uid]
        while fill >= n_emit:
            xs = tuple(buf[:n_emit] for buf in bufs)
            bufs = tuple(torch.cat([buf[n_emit:], buf.new_zeros(buf[:n_emit].shape)])
                         for buf in bufs)
            fill -= n_emit
            ev = {_edge_key(e): xs[e.src.port] for e in down}
            ev = self._run_segment(v, ctx, ev, ext_inputs, caps)
            self._write_pad_rows(v, ctx, ev)
            ctx["ecnt"][v.name] += 1
        ctx["fifo"][v.name] = (bufs, torch.tensor(fill, dtype=torch.int32))

    def _write_pad_rows(self, owner: Block, ctx, edge_vals):
        """Emission rows for the out pads fed from inside owner's segment."""
        for i, e in enumerate(self.out_pad_edges):
            key = self._pad_emit_key.get(i)
            if key is None or self._emit_specs[key][3] is not owner:
                continue
            k = _edge_key(e)
            if k in edge_vals:
                ctx["emit"][key][ctx["ecnt"][owner.name]] = edge_vals[k]

    def _step(self, state, ext_inputs):
        """One time-block: ``(state, ext_inputs) -> (state', (pads, caps))``.
        Builds new state dicts; the input state's tensors are not modified."""
        ctx = {"blocks": dict(state["blocks"]), "tails": dict(state["tails"]),
               "fifo": dict(state["fifo"])}
        if self.vr_blocks:
            ctx["emit"] = {
                key: torch.zeros((rows,) + port.chunk_shape(items),
                                 dtype=port.dtype, device=self.device)
                for key, (rows, items, port, _o) in self._emit_specs.items()}
            ctx["ecnt"] = {v.name: 0 for v in self.vr_blocks}
        caps: Dict[str, Any] = {}
        edge_vals = self._run_segment(None, ctx, {}, ext_inputs, caps)

        pad_outs = []
        for i, e in enumerate(self.out_pad_edges):
            src = e.src.block
            if i in self._pad_emit_key:
                pad_outs.append(ctx["emit"][self._pad_emit_key[i]])
            elif isinstance(src, Pad):
                pad_outs.append(ext_inputs[src.index])
            else:
                pad_outs.append(edge_vals[_edge_key(e)])
        if self.vr_blocks:
            for name, keys in self._vr_sink_keys.items():
                caps[name] = tuple(ctx["emit"][k] for k in keys)
            caps["__vr_counts__"] = dict(ctx["ecnt"])
        if self.debug_taps:
            # every top-level edge value (VR-segment edges live inside the
            # drain loop), as grtpu exposes them
            caps["__edges__"] = dict(edge_vals)
        new_state = {"blocks": ctx["blocks"], "tails": ctx["tails"],
                     "fifo": ctx["fifo"]}
        return new_state, (tuple(pad_outs), caps)

    def step_fn(self):
        """The raw step: ``(state, ext_inputs) -> (state', (pads, caps))``
        over one time-block, for embedding the flowgraph in a larger
        program; pair with :attr:`state` for the initial carry."""
        return self._step

    def step(self, *ext_inputs):
        """Run one time-block; returns (pad_outputs, sink_captures).

        Outputs behind a variable-rate boundary are emission buffers shaped
        (max_emissions, items, ...); the count of valid rows for this step
        is in sink_captures["__vr_counts__"].  ``run``/``stream`` compact
        them."""
        self._check_versions()
        ext_inputs = tuple(self._ingest(x, pad)
                           for x, pad in zip(ext_inputs, self.flat.in_pads))
        for pad, x in zip(self.flat.in_pads, ext_inputs):
            if x.shape[0] != self.chunk_size:
                raise ValueError(
                    f"input pad {pad.index}: expected {self.chunk_size} "
                    f"items, got {x.shape[0]}")
        self.state, (pads, caps) = self._step(self.state, ext_inputs)
        self._advance_tags(self._emitted_from_caps(*self._pop_tag_caps(caps)))
        return pads, caps

    # ------------------------------------------------------------------ run
    def run(self, *ext_inputs, steps: Optional[int] = None,
            device_loop: bool = False):
        """Feed full arrays, stream them through in chunks, return the full
        outputs (tensors on the executor's device).

        The analog of ``tb.run()``: trailing items that do not fill a whole
        chunk are zero-padded and the outputs truncated to the exact
        rational length (fixed-rate pads) or to the exact emission count
        (variable-rate pads; items still queued in a FIFO at the end — less
        than one emission — stay in the carried state).  A graph without
        input pads runs ``steps`` steps.

        ``device_loop=True`` gives the same result from static buffers: the
        state is copied in at entry and out at exit, and on a CUDA device
        each step after a chunk's eager warm-up is replayed from CUDA graphs
        captured once per executor (:mod:`grtpu_torch.runtime.device_loop`),
        with one host read per push of a variable-rate block.  A capture
        that fails raises, naming the block whose ``apply`` broke it where
        that can be found; a run that raises leaves the state as it was at
        entry.  It cannot carry ``debug_taps``.  Each chunk's tag records
        stay on the device until the run has ended; the tag plan is then
        replayed chunk by chunk, as ``step`` would have advanced it."""
        with span("grtpu.run"):
            n_pads = len(self.flat.in_pads)
            if len(ext_inputs) != n_pads:
                raise ValueError(f"graph has {n_pads} input pads, "
                                 f"got {len(ext_inputs)}")
            if n_pads == 0 and steps is None:
                raise ValueError("source-driven graph needs steps=")
            if device_loop:
                self._check_versions()
                if self.debug_taps:
                    raise ValueError("device_loop does not support debug_taps")
                if self._device_loop is None:
                    from grtpu_torch.runtime.device_loop import DeviceLoop

                    self._device_loop = DeviceLoop(self)
                step = self._device_loop.load(self.state)
            else:
                step = self.step
            outs_accum: List[List[torch.Tensor]] = [
                [] for _ in self.flat.out_pads]
            sink_accum: Dict[str, List[tuple]] = {}
            counts_accum: List[Dict[str, int]] = []
            n = None
            if n_pads == 0:
                chunks = [()] * steps
            else:
                xs = [self._ingest(x, pad)
                      for x, pad in zip(ext_inputs, self.flat.in_pads)]
                n = xs[0].shape[0]
                cs = self.chunk_size
                nchunks = -(-n // cs)
                pad_to = nchunks * cs
                if pad_to != n:
                    xs = [torch.cat([x, x.new_zeros((pad_to - n,)
                                                    + x.shape[1:])])
                          for x in xs]
                chunks = (tuple(x[c * cs:(c + 1) * cs] for x in xs)
                          for c in range(nchunks))
            tag_caps = []
            for chunk in chunks:
                pads, caps = step(*chunk)
                if device_loop:
                    tag_caps.append(self._pop_tag_caps(caps))
                self._collect(pads, caps, outs_accum, sink_accum, counts_accum)
            if device_loop:
                self.state = self._device_loop.unload()
                self._replay_tags(tag_caps)
            with span("grtpu.finalize"):
                return self._finalize(outs_accum, sink_accum, n, counts_accum)

    def loop_stats(self) -> Dict[str, float]:
        """A copy of ``run(device_loop=True)``'s counters, summed over every
        such run of this executor (all 0 before the first): ``chunks``,
        ``piece_calls``, ``replays`` and ``replay_s`` (host seconds in the
        replay calls), ``push_reads`` and ``push_wait_s`` (host seconds
        blocked in the read of a variable-rate push's count), ``captures``
        and ``capture_s`` (host seconds capturing the pieces)."""
        from grtpu_torch.runtime.device_loop import new_stats

        loop = self._device_loop
        return dict(loop.stats) if loop is not None else new_stats()

    def loop_node_map(self) -> Dict[str, List[tuple]]:
        """Which block issued each node of ``device_loop``'s captured
        graphs: for each captured piece (``top.0``, ``<variable-rate block
        name>.0``, ...), the kernel, memcpy and memset nodes in the order
        they were captured, as (owner, nodes) runs.  The owner is a block's
        name, or ``"executor"`` for nodes issued outside every ``apply``
        (history concatenation, FIFO shift and push, emission rows,
        commits).  Empty before the first capture and on the CPU."""
        loop = self._device_loop
        return {} if loop is None else {k: list(v)
                                        for k, v in loop.nodes.items()}

    def stream(self, chunk_iter):
        """Generator-driven streaming: pull fixed-size chunks from an
        iterator and yield each step's pad outputs (variable-rate pads
        compacted to the step's emissions)."""
        for chunk in chunk_iter:
            if not isinstance(chunk, (tuple, list)):
                chunk = (chunk,)
            pads, caps = self.step(*chunk)
            if self.vr_blocks:
                counts = [caps["__vr_counts__"]]
                pads = tuple(
                    self._compact_emissions(
                        self._emit_specs[self._pad_emit_key[i]][3], [p], counts)
                    if i in self._pad_emit_key else p
                    for i, p in enumerate(pads))
            yield pads if len(pads) != 1 else pads[0]

    def _collect(self, pads, sinks, outs_accum, sink_accum, counts_accum):
        for i, v in enumerate(pads):
            outs_accum[i].append(v)
        for name, vals in sinks.items():
            if name == "__edges__":
                for k, ev in vals.items():
                    self.edge_data.setdefault(k, []).append(ev)
            elif name == "__vr_counts__":
                counts_accum.append(vals)
            else:
                sink_accum.setdefault(name, []).append(vals)

    @staticmethod
    def _compact_emissions(owner: Block, parts, counts_accum):
        """parts: per-chunk (rows, items, ...) emission buffers; keep each
        chunk's valid rows (that chunk's emission count for the owning VR
        block's segment) and flatten the emissions into one stream."""
        out = [p[:counts[owner.name]].reshape((-1,) + p.shape[2:])
               for p, counts in zip(parts, counts_accum)]
        return torch.cat(out, dim=0) if out else None

    def _finalize(self, outs_accum, sink_accum, n_in, counts_accum):
        pad_outs = []
        for i, parts in enumerate(outs_accum):
            if i in self._pad_emit_key:
                owner = self._emit_specs[self._pad_emit_key[i]][3]
                pad_outs.append(
                    self._compact_emissions(owner, parts, counts_accum))
                continue
            full = torch.cat(parts, dim=0) if parts else None
            if n_in is not None and full is not None:
                # truncate to the exact rational output length of this pad
                full = full[:int(n_in * self._cumulative_rate(self.out_pad_edges[i]))]
            pad_outs.append(full)
        byname = {b.name: b for b in self.order}
        self.sink_data = {}
        for name, vals in sink_accum.items():
            b = byname[name]
            owner = self.block_owner[b.uid]
            if owner is not None:
                self.sink_data[name] = tuple(
                    self._compact_emissions(owner, [v[j] for v in vals],
                                            counts_accum)
                    for j in range(len(vals[0])))
                continue
            exact = None
            if n_in is not None:
                exact = int(n_in * self._cumulative_rate(self._ups[b.uid][0]))
            self.sink_data[name] = tuple(
                torch.cat([v[j] for v in vals], dim=0)[:exact]
                for j in range(len(vals[0])))
        # captures land on the sink blocks (vector_sink_X::data() analog)
        for name, vals in self.sink_data.items():
            byname[name].captured = vals
        if len(pad_outs) == 1:
            return pad_outs[0]
        return tuple(pad_outs)

    def _cumulative_rate(self, edge: Edge) -> Fraction:
        """Total interp/decim product from roots to this edge's source."""
        rate: Dict[int, Fraction] = {}
        for b in self.order:
            anc = [rate[e.src.block.uid] if isinstance(e.src.block, Block)
                   else Fraction(1) for e in self._ups[b.uid].values()]
            rate[b.uid] = (anc[0] if anc else Fraction(1)) * Fraction(
                b.interp, b.decim)
        src = edge.src.block
        if isinstance(src, Pad):
            return Fraction(1)
        return rate[src.uid]

    # ------------------------------------------------------------------ tags
    def _build_tag_plan(self):
        """Precompute the per-block tag-propagation topology once, so that
        the per-step host pass does no graph traversal and, through the
        tagged-edge set, no work at all for blocks with no tags in flight
        on their inputs (the incremental analog of the reference's
        per-iteration tag pass, gr_block_executor.cc:91-156)."""
        self._tagged_edges: set = self._plane.tagged
        self._count_inc: List[tuple] = []
        self._tag_plan: List[tuple] = []
        for b in self.order:
            n_in = self.block_nin[b.uid]
            n_out = (n_in // b.decim * b.interp if not b.variable_rate
                     else int(n_in * b.nominal_rate))
            self._count_inc.append((b.name, n_in, n_out))
            in_list = [(i, _edge_key(e))
                       for i, e in sorted(self._ups[b.uid].items())]
            down_list = [(e.src.port, _edge_key(e),
                          e.dst.block.index if isinstance(e.dst.block, Pad)
                          else None) for e in self._downs[b.uid]]
            self._tag_plan.append((b, in_list, down_list, n_in))

    def _bump_counters(self, steps: int = 1):
        for name, n_in, n_out in self._count_inc:
            self.nitems[name] += n_in * steps
            self.nitems_out[name] += n_out * steps

    def add_tags(self, pad_index: int, tags: Sequence[Tag]):
        """Attach stream tags to an input pad's stream (absolute offsets)."""
        for e in self.flat.edges:
            if isinstance(e.src.block, Pad) and e.src.block.index == pad_index:
                k = _edge_key(e)
                self._tags[k].extend(tags)
                self._tagged_edges.add(k)

    @staticmethod
    def _pop_tag_caps(caps):
        """Split the emitting blocks' records out of a caps dict: returns
        ({name: (ins, outs)}, {name: tagrec}) for the make_tags captures and
        the device_tags records."""
        tagsrc = {k[len("__tagsrc__"):]: caps.pop(k)
                  for k in list(caps) if k.startswith("__tagsrc__")}
        tagdev = {k[len("__tagdev__"):]: caps.pop(k)
                  for k in list(caps) if k.startswith("__tagdev__")}
        return tagsrc, tagdev

    def _emitted_from_caps(self, tagsrc, tagdev):
        """One chunk's emitted Tags from the two kinds of capture (tensors
        or numpy arrays)."""
        if not tagsrc and not tagdev:
            return None
        byname = {b.name: b for b in self.order}
        emitted: Dict[str, List[Tag]] = {}
        for name, (ins, outs) in tagsrc.items():
            emitted[name] = byname[name].make_tags(
                tuple(_to_numpy(a) for a in ins),
                tuple(_to_numpy(a) for a in outs),
                self.nitems[name], self.nitems_out[name])
        for name, rec in tagdev.items():
            emitted[name] = byname[name].tags_from_device(
                {k: _to_numpy(v) for k, v in rec.items()},
                self.nitems[name], self.nitems_out[name])
        return emitted

    def _replay_tags(self, tag_caps):
        """The tag plan over a device_loop run's chunks, in order.  Each
        record is stacked over the chunks and read in one transfer, then
        taken apart chunk by chunk."""
        if not any(src or dev for src, dev in tag_caps):
            for _ in tag_caps:
                self._advance_tags(None)
            return

        def stacked(parts):
            return torch.stack(parts).cpu().numpy()

        src0, dev0 = tag_caps[0]
        src_h = {name: tuple(tuple(stacked([c[0][name][side][j]
                                            for c in tag_caps])
                                   for j in range(len(src0[name][side])))
                             for side in (0, 1))
                 for name in src0}
        dev_h = {name: {k: stacked([c[1][name][k] for c in tag_caps])
                        for k in dev0[name]} for name in dev0}
        for c in range(len(tag_caps)):
            self._advance_tags(self._emitted_from_caps(
                {name: tuple(tuple(a[c] for a in side) for side in sides)
                 for name, sides in src_h.items()},
                {name: {k: v[c] for k, v in rec.items()}
                 for name, rec in dev_h.items()}))

    def _advance_tags(self, emitted: Optional[Dict[str, List[Tag]]] = None):
        """Host-side per-chunk tag propagation (gr_block_executor.cc:91-156).

        TPP_DONT consumes input tags without forwarding; TPP_ALL_TO_ALL
        scales every input tag by relative_rate onto every output edge;
        TPP_ONE_TO_ONE maps input port i's tags to output port i's edges
        only.  ``emitted`` maps emitting-block names to this chunk's new
        Tags, injected onto their output edges (the add_item_tag analog).
        Across a variable-rate boundary, offsets scale by the block's
        *nominal* rate, the approximation the reference makes when a block
        updates tags with set_relative_rate but consumes variably."""
        if emitted or self._tagged_edges:
            self._advance_plane(self._plane, emitted)
        self._bump_counters()

    def _advance_plane(self, plane: _TagPlane,
                       emitted: Optional[Dict[str, List[Tag]]]):
        """One plane's tag pass for the current chunk (the counters are
        bumped by the caller)."""
        tagged = plane.tagged
        if emitted:
            byname = {b.name: b for b in self.order}
            for name, new in emitted.items():
                if not new:
                    continue
                for e in self._downs[byname[name].uid]:
                    k = _edge_key(e)
                    if k in plane.tags:
                        plane.tags[k].extend(new)
                        tagged.add(k)
                    elif isinstance(e.dst.block, Pad):
                        plane.pad_tags.setdefault(
                            e.dst.block.index, []).extend(new)

        for b, in_list, down_list, n_in in self._tag_plan:
            hit = [ik for ik in in_list if ik[1] in tagged]
            if not hit:
                continue
            limit = self.nitems[b.name] + n_in
            in_by_port: Dict[int, List[Tag]] = {}
            for i, k in hit:
                lst = plane.tags[k]
                take = [t for t in lst if t.offset < limit]
                if take:
                    keep = [t for t in lst if t.offset >= limit]
                    plane.tags[k] = keep
                    if not keep:
                        tagged.discard(k)
                    in_by_port[i] = take
            if not in_by_port:
                continue
            all_in = [t for ts in in_by_port.values() for t in ts]
            if not b.out_ports:
                # terminal blocks keep their received tags for the host
                # (the analog of reading gr_buffer tags at a sink)
                plane.sink_tags.setdefault(b.name, []).extend(all_in)
                continue
            if b.tag_propagation == "dont":
                continue  # consumed, not forwarded (TPP_DONT)
            for src_port, k, dst_pad in down_list:
                src_tags = (in_by_port.get(src_port, [])
                            if b.tag_propagation == "one_to_one" else all_in)
                if not src_tags:
                    continue
                out_tags = propagate_tags(src_tags, b.relative_rate)
                if dst_pad is not None:
                    plane.pad_tags.setdefault(dst_pad, []).extend(out_tags)
                elif k in plane.tags:
                    plane.tags[k].extend(out_tags)
                    tagged.add(k)

    def dump_debug_taps(self, directory: str) -> Dict[str, str]:
        """Write every edge's captured stream to ``<dir>/<edge>.dat`` (raw
        native items, grtpu's file names) — the log-every-stage debugging
        workflow.  Returns {edge key: path}."""
        import os

        os.makedirs(directory, exist_ok=True)
        paths = {}
        for k, parts in self.edge_data.items():
            arr = torch.cat(parts, dim=0).cpu().numpy()
            safe = k.replace("/", "_").replace(">", "").replace(".", "_")
            path = os.path.join(directory, safe + ".dat")
            arr.tofile(path)
            paths[k] = path
        return paths

    # ------------------------------------------------------------------ ckpt
    def _canonical_leaf_paths(self):
        """(canonical_path, state_path, leaf) per state tensor, sorted by
        canonical path (stable, so NamedTuple fields keep their order).

        grtpu's canonical form (executor.py:1195-1236): block identity is
        the TOPOLOGICAL position plus the declared rate signature — never
        the process-global uid baked into auto-generated block names — so a
        checkpoint restores into any identically-built flowgraph, in either
        package."""
        uid2tok, name2tok = {}, {}
        for i, b in enumerate(self.order):
            tok = (f"{i}:{type(b).__name__}:"
                   f"d{b.decim}i{b.interp}h{b.history}")
            uid2tok[str(b.uid)] = tok
            name2tok[b.name] = tok

        def canon_edge(k):
            src, dst = k.split("->")
            sn, sp = src.rsplit(".", 1)
            dn, dp = dst.rsplit(".", 1)
            return (f"{name2tok.get(sn, sn)}.{sp}->"
                    f"{name2tok.get(dn, dn)}.{dp}")

        canon = {"blocks": lambda k: uid2tok.get(k, k), "tails": canon_edge,
                 "fifo": lambda k: name2tok.get(k, k)}
        out = []
        for path, leaf in _leaves(self.state):
            parts = ["None" if isinstance(p, _AttrKey) else p for p in path]
            if len(parts) > 1:
                parts[1] = canon[parts[0]](parts[1])
            out.append(("/".join(parts), path, leaf))
        return sorted(out, key=lambda t: t[0])

    def save_checkpoint(self, path: str):
        """Persist the full flowgraph state (block states, halo tails and VR
        FIFOs) in grtpu's npz format."""
        entries = self._canonical_leaf_paths()
        np.savez(
            path,
            *[leaf.detach().cpu().numpy() for _, _, leaf in entries],
            __paths__=np.array([c for c, _, _ in entries]),
        )

    def load_checkpoint(self, path: str):
        """Restore a checkpoint written by this package or by grtpu.  Each
        leaf lands on the device of the state tensor it replaces."""
        data = np.load(path, allow_pickle=False)
        entries = self._canonical_leaf_paths()
        if "__paths__" not in data:
            raise ValueError("not a grtpu checkpoint (no __paths__ record)")
        saved_paths = [str(s) for s in data["__paths__"]]
        mine = [c for c, _, _ in entries]
        if saved_paths != mine:
            extra = sorted(set(saved_paths) - set(mine))
            missing = sorted(set(mine) - set(saved_paths))
            raise ValueError(
                "checkpoint structure does not match this flowgraph: "
                f"checkpoint-only leaves {extra[:4]}, "
                f"flowgraph-only leaves {missing[:4]}")
        new = {}
        for j, (canon, spath, leaf) in enumerate(entries):
            saved = data[f"arr_{j}"]
            if tuple(saved.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {canon!r} shape {saved.shape} != "
                    f"flowgraph state shape {tuple(leaf.shape)}")
            new[spath] = torch.from_numpy(np.array(saved)).to(
                device=leaf.device, dtype=leaf.dtype)
        self.state = _replace_leaves(self.state, new)
