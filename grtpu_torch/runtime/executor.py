"""Time-block stream executor over torch tensors (the fixed-rate part).

Port of ``grtpu.runtime.executor.StreamExecutor``.  A flowgraph runs over
fixed-size time-blocks (chunks): every edge's per-step item count is fixed
by static rate propagation before the first step, each input carries the
last ``history - 1`` items of the previous chunk (the halo tails, carried
state), and the blocks run eagerly in topological order on one
``torch.device``.

The executor state is a dict of tensors on that device:
``{"blocks": {uid: block state}, "tails": {edge: halo}, "fifo": {}}``.
Checkpoints use grtpu's own npz format (``arr_j`` arrays under canonical,
topology-relative ``__paths__``), so a flowgraph checkpointed by grtpu
resumes here, and the reverse.

Ported: topology, static rate propagation with the demand-balancing retry,
``required_multiple``, halo tails, ``step``/``step_fn``/``run``/``stream``,
the stale-parameter guard and checkpoints.  Not ported yet (each raises
``NotImplementedError`` naming its item in ROADMAP.md's list "Executor
features still to port"): variable-rate blocks, stream tags in flight,
``device_loop``, ``fuse_firs`` and ``debug_taps``.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from grtpu_torch.runtime.block import Block
from grtpu_torch.runtime.graph import Edge, FlatGraph, Graph, Pad
from grtpu_torch.runtime.tags import Tag

_PORT_ITEMS = {
    "variable-rate blocks": 1,
    "stream tags": 2,
    "device_loop": 3,
    "fuse_firs": 4,
    "debug_taps": 5,
}


def _not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} are not ported to grtpu_torch yet: see ROADMAP.md, "
        f"'Executor features still to port', item {_PORT_ITEMS[feature]}")


def _edge_key(e: Edge) -> str:
    return f"{e.src.block.name}.{e.src.port}->{e.dst.block.name}.{e.dst.port}"


def _tree_to(tree, device):
    """Move every tensor of a state tree (tensor / tuple / list / dict)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def _leaves(tree, path=()):
    """(path, tensor) for every tensor of a state tree, dict keys and
    sequence indices as path parts (jax.tree_util's key paths)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
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
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replace_leaves(v, new, path + (str(i),))
                          for i, v in enumerate(tree))
    return tree


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
      device: the torch device that holds the state and runs every block.
        Host inputs are moved there at ``run``/``step`` entry.
      debug_taps, fuse_firs: grtpu options not ported yet (they raise).
    """

    def __init__(
        self,
        graph: Graph | FlatGraph,
        chunk_size: Optional[int] = 4096,
        root_chunks: Optional[Dict[Any, int]] = None,
        device="cpu",
        debug_taps: bool = False,
        fuse_firs: bool = False,
    ):
        if debug_taps:
            raise _not_ported("debug_taps")
        if fuse_firs:
            raise _not_ported("fuse_firs")
        self.flat = graph.flatten() if isinstance(graph, Graph) else graph
        self.order = self.flat.topological_order()
        for b in self.order:
            if b.variable_rate:
                raise _not_ported("variable-rate blocks")
            if b.emits_tags:
                raise _not_ported("stream tags")
        self.device = torch.device(device)
        self._ups = {b.uid: self.flat.upstream_of(b) for b in self.order}
        self._downs = {b.uid: self.flat.downstream_of(b) for b in self.order}
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
                self._compute_rates(root_chunks)
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
        self.state = self._make_state()
        self.sink_data: Dict[str, tuple] = {}
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
    def _compute_rates(self, root_chunks):
        """Static rate propagation, replacing gr_block::forecast(): every
        edge gets a per-step item count, every block its per-step input
        count n_in (gr_flat_flowgraph.cc:89-122, exactly)."""
        self.edge_items: Dict[str, int] = {}
        self.block_nin: Dict[int, int] = {}
        pad_chunk = {id(pad): int(root_chunks.get(pad, self.chunk_size))
                     for pad in self.flat.in_pads}
        self._pad_chunk = pad_chunk
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
            for e in self._downs[b.uid]:
                self.edge_items[_edge_key(e)] = n_in // b.decim * b.interp

        self.out_pad_edges: List[Edge] = []
        for pad in self.flat.out_pads:
            feed = [e for e in self.flat.edges if e.dst.block is pad]
            if len(feed) != 1:
                raise ValueError(f"output pad {pad.name} must have exactly one driver")
            self.out_pad_edges.append(feed[0])

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

    def required_multiple(self) -> int:
        """Exact chunk-size divisibility requirement: for input count C*r (r
        the cumulative rate fraction) to be a positive multiple of decim, C
        must be a multiple of decim*den(r)/gcd(num(r), decim*den(r))."""
        mult = 1
        rate_to: Dict[int, Fraction] = {}
        for b in self.order:
            rs = {rate_to[e.src.block.uid] if isinstance(e.src.block, Block)
                  else Fraction(1) for e in self._ups[b.uid].values()}
            r = rs.pop() if rs else Fraction(1)
            need = (b.decim * r.denominator) // math.gcd(
                r.numerator, b.decim * r.denominator)
            mult = math.lcm(mult, need)
            rate_to[b.uid] = r * Fraction(b.interp, b.decim)
        return mult

    # ------------------------------------------------------------------ state
    def _make_state(self):
        """The initial state dict, on the executor's device."""
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
        return {"blocks": blocks, "tails": tails, "fifo": {}}

    def _ingest(self, x, pad: Pad) -> torch.Tensor:
        """Host or device input -> a tensor of the pad's dtype on the
        executor's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=pad.port.dtype)

    # ------------------------------------------------------------------ step
    def _step(self, state, ext_inputs):
        """One time-block: ``(state, ext_inputs) -> (state', (pads, caps))``.
        Builds new state dicts; the input state is not modified."""
        blocks = dict(state["blocks"])
        tails = dict(state["tails"])
        edge_vals: Dict[str, torch.Tensor] = {}
        caps: Dict[str, tuple] = {}
        for b in self.order:
            ups = self._ups[b.uid]
            ins = []
            for i in range(len(b.in_ports)):
                e = ups[i]
                src = e.src.block
                v = (ext_inputs[src.index] if isinstance(src, Pad)
                     else edge_vals[_edge_key(e)])
                if b.history > 1:
                    k = _edge_key(e)
                    full = torch.cat([tails[k], v], dim=0)
                    tails[k] = full[full.shape[0] - (b.history - 1):]
                    v = full
                ins.append(v)
            uid = str(b.uid)
            if not b.in_ports:
                n_out = self.block_nin[b.uid] // b.decim * b.interp
                new_s, outs = b.apply(blocks[uid], n_out)
            else:
                new_s, outs = b.apply(blocks[uid], *ins)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            if len(outs) != len(b.out_ports):
                raise ValueError(
                    f"{b.name}: apply returned {len(outs)} outputs, "
                    f"declared {len(b.out_ports)} ports")
            blocks[uid] = new_s
            if not b.out_ports and ins:
                caps[b.name] = tuple(ins)
            for e in self._downs[b.uid]:
                edge_vals[_edge_key(e)] = outs[e.src.port]

        pad_outs = []
        for e in self.out_pad_edges:
            src = e.src.block
            pad_outs.append(ext_inputs[src.index] if isinstance(src, Pad)
                            else edge_vals[_edge_key(e)])
        new_state = {"blocks": blocks, "tails": tails, "fifo": state["fifo"]}
        return new_state, (tuple(pad_outs), caps)

    def step_fn(self):
        """The raw step: ``(state, ext_inputs) -> (state', (pads, caps))``
        over one time-block, for embedding the flowgraph in a larger
        program; pair with :attr:`state` for the initial carry."""
        return self._step

    def step(self, *ext_inputs):
        """Run one time-block; returns (pad_outputs, sink_captures)."""
        self._check_versions()
        ext_inputs = tuple(self._ingest(x, pad)
                           for x, pad in zip(ext_inputs, self.flat.in_pads))
        for pad, x in zip(self.flat.in_pads, ext_inputs):
            if x.shape[0] != self.chunk_size:
                raise ValueError(
                    f"input pad {pad.index}: expected {self.chunk_size} "
                    f"items, got {x.shape[0]}")
        self.state, (pads, caps) = self._step(self.state, ext_inputs)
        return pads, caps

    # ------------------------------------------------------------------ run
    def run(self, *ext_inputs, steps: Optional[int] = None,
            device_loop: bool = False):
        """Feed full arrays, stream them through in chunks, return the full
        outputs (tensors on the executor's device).

        The analog of ``tb.run()``: trailing items that do not fill a whole
        chunk are zero-padded and the outputs truncated to the exact
        rational length.  A graph without input pads runs ``steps`` steps."""
        if device_loop:
            raise _not_ported("device_loop")
        n_pads = len(self.flat.in_pads)
        if len(ext_inputs) != n_pads:
            raise ValueError(f"graph has {n_pads} input pads, got {len(ext_inputs)}")
        outs_accum: List[List[torch.Tensor]] = [[] for _ in self.flat.out_pads]
        sink_accum: Dict[str, List[tuple]] = {}
        if n_pads == 0:
            if steps is None:
                raise ValueError("source-driven graph needs steps=")
            for _ in range(steps):
                self._collect(*self.step(), outs_accum, sink_accum)
            return self._finalize(outs_accum, sink_accum, None)

        xs = [self._ingest(x, pad) for x, pad in zip(ext_inputs, self.flat.in_pads)]
        n = xs[0].shape[0]
        cs = self.chunk_size
        nchunks = -(-n // cs)
        pad_to = nchunks * cs
        if pad_to != n:
            xs = [torch.cat([x, x.new_zeros((pad_to - n,) + x.shape[1:])])
                  for x in xs]
        for c in range(nchunks):
            chunk = tuple(x[c * cs:(c + 1) * cs] for x in xs)
            self._collect(*self.step(*chunk), outs_accum, sink_accum)
        return self._finalize(outs_accum, sink_accum, n)

    def stream(self, chunk_iter):
        """Generator-driven streaming: pull fixed-size chunks from an
        iterator and yield each step's pad outputs."""
        for chunk in chunk_iter:
            if not isinstance(chunk, (tuple, list)):
                chunk = (chunk,)
            pads, _ = self.step(*chunk)
            yield pads if len(pads) != 1 else pads[0]

    @staticmethod
    def _collect(pads, sinks, outs_accum, sink_accum):
        for i, v in enumerate(pads):
            outs_accum[i].append(v)
        for name, vals in sinks.items():
            sink_accum.setdefault(name, []).append(vals)

    def _finalize(self, outs_accum, sink_accum, n_in):
        pad_outs = []
        for i, parts in enumerate(outs_accum):
            full = torch.cat(parts, dim=0) if parts else None
            if n_in is not None and full is not None:
                # truncate to the exact rational output length of this pad
                full = full[:int(n_in * self._cumulative_rate(self.out_pad_edges[i]))]
            pad_outs.append(full)
        byname = {b.name: b for b in self.order}
        self.sink_data = {}
        for name, vals in sink_accum.items():
            exact = None
            if n_in is not None:
                ups = self._ups[byname[name].uid]
                exact = int(n_in * self._cumulative_rate(ups[0]))
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
    def add_tags(self, pad_index: int, tags: Sequence[Tag]):
        """Attach stream tags to an input pad's stream (not ported yet)."""
        raise _not_ported("stream tags")

    # ------------------------------------------------------------------ ckpt
    def _canonical_leaf_paths(self):
        """(canonical_path, state_path, leaf) per state tensor.

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
            parts = list(path)
            if len(parts) > 1:
                parts[1] = canon[parts[0]](parts[1])
            out.append(("/".join(parts), path, leaf))
        return sorted(out, key=lambda t: t[0])

    def save_checkpoint(self, path: str):
        """Persist the full flowgraph state (block states + halo tails) in
        grtpu's npz format."""
        entries = self._canonical_leaf_paths()
        np.savez(
            path,
            *[leaf.detach().cpu().numpy() for _, _, leaf in entries],
            __paths__=np.array([c for c, _, _ in entries]),
        )

    def load_checkpoint(self, path: str):
        """Restore a checkpoint written by this package or by grtpu."""
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
                device=self.device, dtype=leaf.dtype)
        self.state = _replace_leaves(self.state, new)
