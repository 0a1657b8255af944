"""Mesh-aware stream executor: run any flowgraph over a mesh of devices.

Port of ``grtpu.runtime.mesh_executor``.  The reference makes every
flowgraph parallel by construction (one thread per block; N identical
sub-pipelines scale across cores, gr_scheduler_tpb.cc:53-78,
mp-sched/synthetic.py:28-45).  This module runs the same
:class:`~grtpu_torch.runtime.executor.StreamExecutor` step over a
:class:`~grtpu_torch.parallel.mesh.Mesh` with two data axes, driven by one
process (why: :mod:`grtpu_torch.parallel.mesh`):

* ``chan`` — independent channel instances of the flowgraph (the mp-sched
  N-pipeline fan-out).  Channel c belongs to column c // (nchannels /
  chan size).
* ``time`` — the stream inside one chunk, split into S contiguous slices,
  one a time shard.  Each block's declared ``history`` reaches shard i as
  an overlap-save halo copied from shard i-1 (shard 0 takes the carried
  tail), replacing the reference's buffer-reader preload
  (gr_flat_flowgraph.cc:124-152).  Blocks whose only cross-chunk state is
  the halo run shard by shard from the same state; blocks with carried
  recurrent state (IIR, rotators, loops) are shard-serial: shard i+1 starts
  from shard i's final state, copied to its device, which is the arithmetic
  of grtpu's chained ``ppermute``.  Variable-rate segments cannot split
  over time (their consumption depends on the data): a variable-rate block
  under ``time`` > 1 is rejected, as grtpu rejects it.

Channels inside a shard take the loop route: each channel runs the
single-device step (``StreamExecutor._step``, or over time shards the
time-sharded step of this module) with its own state, one channel after
the other.  That is exact by construction, and it is the only route for
variable-rate segments, whose drain reads the host once a push.  grtpu
``vmap`` s the step over the channel axis instead; the port's hand kernels
launch through ``ctypes``, which ``torch.func.vmap`` cannot batch.

State: each channel's state is the single-device executor's state dict,
kept on its column's home device, the device of the column's LAST time
shard (the carried tails and recurrent states are made at the stream's
end; shard 0 reads them from there at the next step).  :attr:`state` is
grtpu's layout: every leaf with a leading ``nchannels`` axis (the FIFO fill
counts on the host), so checkpoints are grtpu's npz format and restore on
a mesh of another shape, or in grtpu.

``run(device_loop=True)``: for a fixed-rate graph without tag emitters,
the whole mesh step (every channel and shard, and the halo and state
copies between shards) is one CUDA graph over static buffers, captured at
its second call and replayed for every later chunk (on a mesh of one
card; on the CPU each call runs it).  A graph with variable-rate blocks or
tag emitters keeps one ``DeviceLoop`` a channel (``runtime/device_loop.py``)
on its column's device.  Both give results ``torch.equal`` to ``step``.

Stream tags: every channel is its own linear stream, so the mesh holds
one host tag plane per channel (``chan_planes``).  Tag-emitting blocks
must implement the ``device_tags`` contract (a fixed-size record a chunk);
propagation replays the shared host plan per channel.  A time-sharded
mesh would need per-shard offset rebasing and is rejected for emitters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from grtpu_torch.parallel.mesh import (Mesh, time_chan_mesh, tree_leaves,
                                       tree_map, tree_stack)
from grtpu_torch.runtime.block import Block
from grtpu_torch.runtime.executor import (StreamExecutor, _TagPlane,
                                          _edge_key, _leaves)
from grtpu_torch.runtime.graph import FlatGraph, Graph, Pad


def make_mesh(n_devices: int, devices=None, time: Optional[int] = None) -> Mesh:
    """2-D ``("time", "chan")`` mesh of ``devices[:n_devices]`` (n logical
    shards on the card when not given); degenerate axes allowed.

    ``time`` fixes the time axis's size; by default a modest time axis (4
    or 2) with at least 2 channel shards, else pure channel sharding."""
    return time_chan_mesh(n_devices, devices, time)


def _join_into(out, pieces_by_chan):
    """Write each channel's pieces, joined on their leading axis, into row
    c of ``out``."""
    for c, pieces in enumerate(pieces_by_chan):
        o = 0
        for p in pieces:
            out[c, o:o + p.shape[0]] = p.to(out.device)
            o += p.shape[0]


def _joined(pieces_by_chan, device):
    first = pieces_by_chan[0]
    shape = ((len(pieces_by_chan), sum(p.shape[0] for p in first))
             + tuple(first[0].shape[1:]))
    out = torch.empty(shape, dtype=first[0].dtype, device=device)
    _join_into(out, pieces_by_chan)
    return out


class MeshExecutor(StreamExecutor):
    """Run a flowgraph over ``nchannels`` independent channel instances,
    split over a mesh.

    Args:
      graph: any :class:`Graph` / :class:`FlatGraph` (variable-rate blocks
        included; those need the mesh's time axis to be 1).
      mesh: a :class:`~grtpu_torch.parallel.mesh.Mesh` whose entries all
        belong to this process; the axes named ``chan_axis`` and
        ``time_axis`` are used where present, any other axis at coordinate
        0.
      nchannels: the channel count (a multiple of the chan axis's size).
        Inputs and outputs gain a leading ``nchannels`` dimension.
      chunk_size: per-channel items a step, as in StreamExecutor.  With
        time shards each shard takes ``chunk_size / time`` items, and every
        block's per-shard input must still be a multiple of its decimation
        and cover its history.
    """

    def __init__(
        self,
        graph: Graph | FlatGraph,
        mesh: Mesh,
        nchannels: int,
        *,
        chan_axis: str = "chan",
        time_axis: str = "time",
        chunk_size: Optional[int] = 4096,
        root_chunks: Optional[Dict[Any, int]] = None,
        vr_chunks: Optional[Dict[Any, int]] = None,
    ):
        self.mesh = mesh
        self.nchannels = int(nchannels)
        self._chan = chan_axis if chan_axis in mesh.shape else None
        self._time = time_axis if time_axis in mesh.shape else None
        self.s_chan = mesh.shape.get(chan_axis, 1)
        self.s_time = mesh.shape.get(time_axis, 1)
        if self.nchannels % self.s_chan:
            raise ValueError(
                f"nchannels={nchannels} not divisible by chan axis size "
                f"{self.s_chan}")
        if mesh.spans_processes:
            raise NotImplementedError(
                "MeshExecutor drives the entries of one process; across "
                "processes feed each one's entries with grtpu_torch.parallel."
                "multihost")
        self._per_col = self.nchannels // self.s_chan
        self._lanes: Dict[torch.device, StreamExecutor] = {}
        self._root_chunks, self._vr_chunks = root_chunks, vr_chunks
        self._loop = None            # run(device_loop=True)'s runner
        super().__init__(graph, chunk_size=chunk_size,
                         root_chunks=root_chunks, vr_chunks=vr_chunks,
                         device=self._entry(0, 0))
        for b in self.order:
            if b.emits_tags and not b.device_tags:
                raise NotImplementedError(
                    f"{b.name}: legacy make_tags emitters capture full "
                    f"chunks on the host and may keep host state per "
                    f"stream; under MeshExecutor implement the in-jit "
                    f"device_tags contract (apply_tagged/tags_from_device) "
                    f"instead")
            if b.emits_tags and self.s_time > 1:
                raise NotImplementedError(
                    f"{b.name}: tag emission under a time-sharded mesh "
                    f"would need per-shard offset rebasing; use a mesh "
                    f"with a size-1 time axis (shard over 'chan')")
        if self.vr_blocks and self.s_time > 1:
            raise NotImplementedError(
                "variable-rate blocks consume at a data-dependent rate; a "
                "static time split cannot be rate-aligned across shards. "
                "Use a mesh with a size-1 time axis and shard over 'chan'.")
        if self.s_time > 1:
            self._validate_time_sharding()
        # device_loop keeps a DeviceLoop a channel where the host must read
        # the card inside a step (variable-rate pushes) or replay tag records
        self._chan_loops = bool(self.vr_blocks) or any(
            b.emits_tags for b in self.order)

    # ------------------------------------------------------------ layout
    def _entry(self, t: int, c: int) -> torch.device:
        idx = [0] * self.mesh.devices.ndim
        if self._time is not None:
            idx[self.mesh.axis(self._time)] = t
        if self._chan is not None:
            idx[self.mesh.axis(self._chan)] = c
        return self.mesh.devices[tuple(idx)]

    def _shard_devices(self, c: int) -> List[torch.device]:
        """The devices of channel c's time shards, in time order."""
        col = c // self._per_col
        return [self._entry(t, col) for t in range(self.s_time)]

    def _home(self, c: int) -> torch.device:
        return self._entry(self.s_time - 1, c // self._per_col)

    def _lane(self, device) -> StreamExecutor:
        """The single-device executor of this graph on ``device`` (this
        executor on its own device): its step is the step of a channel
        that lives there."""
        if device == self.device:
            return self
        if device not in self._lanes:
            self._lanes[device] = StreamExecutor(
                self.flat, chunk_size=self.chunk_size,
                root_chunks=self._root_chunks, vr_chunks=self._vr_chunks,
                device=device)
        return self._lanes[device]

    @property
    def route(self) -> str:
        """How the channels of a shard run, and how ``device_loop`` runs
        the step."""
        loop = ("a DeviceLoop a channel" if self._chan_loops
                else "one CUDA graph for the whole mesh step")
        return f"loop (channels one after the other); device_loop: {loop}"

    # ------------------------------------------------------------ state
    def _make_state(self):
        one = super()._make_state()
        return tree_map(lambda leaf: torch.stack([leaf] * self.nchannels), one)

    @property
    def state(self):
        """Every channel's state, each leaf stacked on a leading
        ``nchannels`` axis (on channel 0's device; the FIFO fills on the
        host)."""
        return tree_stack(self._chans)

    @state.setter
    def state(self, tree):
        chans = []
        for c in range(self.nchannels):
            home = self._home(c)
            chans.append({
                "blocks": tree_map(lambda leaf: leaf[c].to(home),
                                   tree["blocks"]),
                "tails": {k: v[c].to(home) for k, v in tree["tails"].items()},
                "fifo": {name: (tuple(b[c].to(home) for b in bufs),
                                fill[c].clone())
                         for name, (bufs, fill) in tree["fifo"].items()}})
        self._chans = chans

    def _validate_time_sharding(self):
        S = self.s_time
        for b in self.order:
            n_in = self.block_nin[b.uid]
            if n_in % S:
                raise ValueError(
                    f"{b.name}: per-step input {n_in} not divisible by "
                    f"time axis size {S}; raise chunk_size")
            n_loc = n_in // S
            if n_loc % b.decim:
                raise ValueError(
                    f"{b.name}: per-shard input {n_loc} not a multiple of "
                    f"decim={b.decim}; raise chunk_size")
            if b.in_ports and n_loc < b.history - 1:
                raise ValueError(
                    f"{b.name}: per-shard input {n_loc} smaller than "
                    f"history-1={b.history - 1}; raise chunk_size")
            if not b.in_ports:
                n_out = n_in // b.decim * b.interp
                if n_out % S:
                    raise ValueError(
                        f"{b.name}: source production {n_out} not "
                        f"divisible by time axis size {S}")

    # ------------------------------------------------------------ step
    def _time_step(self, c: int, state, xs):
        """One channel's time-block over its S time shards.  ``xs``: per
        input pad, the S per-shard chunks.  Returns (state', (pads, caps))
        with each output pad and sink capture a list of S pieces."""
        devs = self._shard_devices(c)
        S = len(devs)
        blocks = dict(state["blocks"])
        tails = dict(state["tails"])
        edge_vals: Dict[str, list] = {}
        caps: Dict[str, tuple] = {}
        for b in self.order:
            ups = self._ups[b.uid]
            ins, fresh = [], []
            for i in range(len(b.in_ports)):
                e = ups[i]
                src = e.src.block
                v = (xs[src.index] if isinstance(src, Pad)
                     else edge_vals[_edge_key(e)])
                fresh.append(v)
                if b.history > 1:
                    # the halo: shard 0 takes the carried tail, shard i the
                    # last h items of shard i-1's input
                    h = b.history - 1
                    k = _edge_key(e)
                    prev = [tails[k]] + [p[p.shape[0] - h:] for p in v[:-1]]
                    v = [torch.cat([p.to(d), x]) for p, d, x in zip(prev, devs, v)]
                    tails[k] = v[-1][v[-1].shape[0] - h:]
                ins.append(v)
            uid = str(b.uid)
            st = blocks[uid]
            stateless = not tree_leaves(st)
            outs = []
            for s, dev in enumerate(devs):
                st_s = st if stateless else tree_map(lambda t: t.to(dev), st)
                if not b.in_ports:
                    n_loc = self.block_nin[b.uid] // b.decim * b.interp // S
                    if b.source_takes_device:
                        new_s, o = b.apply(st_s, n_loc, device=dev)
                    else:
                        new_s, o = b.apply(st_s, n_loc)
                else:
                    new_s, o = b.apply(st_s, *(v[s] for v in ins))
                if not stateless:
                    st = new_s          # shard-serial: the next shard's start
                outs.append(self._fixed_outputs(b, o))
            blocks[uid] = st
            if not b.out_ports and ins:
                caps[b.name] = tuple(fresh)
            for e in self._downs[b.uid]:
                edge_vals[_edge_key(e)] = [o[e.src.port] for o in outs]
        pads = []
        for e in self.out_pad_edges:
            src = e.src.block
            pads.append(xs[src.index] if isinstance(src, Pad)
                        else edge_vals[_edge_key(e)])
        new_state = {"blocks": blocks, "tails": tails,
                     "fifo": dict(state["fifo"])}
        return new_state, (pads, caps)

    def _chan_step(self, c: int, state, xs):
        """Channel c's step, pads and sink captures as lists of per-shard
        pieces: over time shards the time-sharded step, else the
        single-device step on the channel's device (one piece)."""
        if self.s_time > 1:
            return self._time_step(c, state, xs)
        lane = self._lane(self._home(c))
        st, (pads, caps) = lane._step(state, tuple(x[0] for x in xs))
        caps = {k: v if k.startswith("__") else tuple([u] for u in v)
                for k, v in caps.items()}
        return st, ([[p] for p in pads], caps)

    def _shard_inputs(self, chunk) -> List[list]:
        """Per channel, per input pad, the S per-shard views of a chunk of
        (nchannels, n, ...) tensors."""
        S = self.s_time
        out = []
        for c in range(self.nchannels):
            devs = self._shard_devices(c)
            per_pad = []
            for x in chunk:
                n = x.shape[1] // S
                per_pad.append([x[c, i * n:(i + 1) * n].to(devs[i])
                                for i in range(S)])
            out.append(per_pad)
        return out

    def _assemble(self, results, outs=None):
        """Join the channels' (pads, caps) into (nchannels, ...) tensors,
        or write them into ``outs`` (the same structure, preallocated);
        returns (pads, caps, per-channel tag records)."""
        dev = self.device
        tagrecs, caps_c = [], []
        for _, caps in results:
            caps = dict(caps)
            tagrecs.append(self._pop_tag_caps(caps))
            caps_c.append(caps)
        pads = []
        for i in range(len(self.out_pad_edges)):
            pieces = [r[0][i] for r in results]
            if outs is None:
                pads.append(_joined(pieces, dev))
            else:
                _join_into(outs[0][i], pieces)
                pads.append(outs[0][i])
        caps = {}
        for name, val in caps_c[0].items():
            if name == "__vr_counts__":
                caps[name] = {k: np.array([cc[name][k] for cc in caps_c],
                                          dtype=np.int64) for k in val}
                continue
            ports = []
            for j in range(len(val)):
                pieces = [cc[name][j] for cc in caps_c]
                if outs is None:
                    ports.append(_joined(pieces, dev))
                else:
                    _join_into(outs[1][name][j], pieces)
                    ports.append(outs[1][name][j])
            caps[name] = tuple(ports)
        return tuple(pads), caps, tagrecs

    def _ingest_all(self, ext_inputs):
        xs = []
        for pad, x in zip(self.flat.in_pads, ext_inputs):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            xs.append(x.to(device=self.device, dtype=pad.port.dtype))
        return xs

    def step(self, *ext_inputs):
        """One time-block over all channels.  Inputs and outputs carry a
        leading ``nchannels`` dim; variable-rate emission buffers carry
        per-channel valid counts in caps['__vr_counts__'] (an (nchannels,)
        array a block)."""
        self._check_versions()
        xs = self._ingest_all(ext_inputs)
        for pad, x in zip(self.flat.in_pads, xs):
            want = (self.nchannels, self._pad_chunk[id(pad)])
            if tuple(x.shape[:2]) != want:
                raise ValueError(
                    f"input pad {pad.index}: expected leading shape {want} "
                    f"(nchannels, chunk), got {tuple(x.shape[:2])}")
        shards = self._shard_inputs(xs)
        results = []
        for c in range(self.nchannels):
            self._chans[c], res = self._chan_step(c, self._chans[c], shards[c])
            results.append(res)
        pads, caps, tagrecs = self._assemble(results)
        self._advance_mesh_tags(tagrecs)
        return pads, caps

    # ------------------------------------------------------------ tags
    @property
    def chan_planes(self):
        """One host tag plane per channel's stream."""
        if not hasattr(self, "_chan_planes"):
            self._chan_planes = [_TagPlane(self._edge_keys)
                                 for _ in range(self.nchannels)]
        return self._chan_planes

    def add_tags(self, pad_index, tags, channel: Optional[int] = None):
        """Attach stream tags to an input pad; ``channel=None`` applies
        them to every channel's stream."""
        chans = range(self.nchannels) if channel is None else [channel]
        for e in self.flat.edges:
            if isinstance(e.src.block, Pad) and e.src.block.index == pad_index:
                k = _edge_key(e)
                for c in chans:
                    plane = self.chan_planes[c]
                    plane.tags[k].extend(tags)
                    plane.tagged.add(k)

    def sink_tags_chan(self, name: str, channel: int):
        """Tags retained at sink block ``name`` on one channel's stream."""
        return self.chan_planes[channel].sink_tags.get(name, [])

    def pad_tags_chan(self, pad_index: int, channel: int):
        """Tags that crossed output pad ``pad_index`` on one channel."""
        return self.chan_planes[channel].pad_tags.get(pad_index, [])

    def _advance_mesh_tags(self, tagrecs):
        """One chunk's tag pass: each channel's records advance that
        channel's plane; the item counters bump once."""
        planes = getattr(self, "_chan_planes", None)
        if any(src or dev for src, dev in tagrecs) or (
                planes is not None and any(p.tagged for p in planes)):
            for plane, (src, dev) in zip(self.chan_planes, tagrecs):
                emitted = self._emitted_from_caps(src, dev)
                if emitted or plane.tagged:
                    self._advance_plane(plane, emitted or {})
        self._bump_counters()

    # ------------------------------------------------------------ run
    def run(self, *ext_inputs, steps: Optional[int] = None,
            device_loop: bool = False):
        """Stream (nchannels, n) inputs through in chunks; returns each
        fixed-rate output pad as a (nchannels, n_out) tensor and each
        variable-rate pad as a per-channel list of tensors (channels consume
        at independent recovered rates).  Sink captures land in
        ``self.sink_data`` with the same convention.

        ``device_loop=True`` runs every chunk from static buffers: one CUDA
        graph for the whole mesh step (fixed-rate graphs), or a
        ``DeviceLoop`` a channel (variable-rate blocks or tag emitters);
        results ``torch.equal`` to the stepwise run, the tag records read
        after the run."""
        n_pads = len(self.flat.in_pads)
        if len(ext_inputs) != n_pads:
            raise ValueError(
                f"graph has {n_pads} input pads, got {len(ext_inputs)}")
        if n_pads == 0 and steps is None:
            raise ValueError("source-driven graph needs steps=")
        n = None
        if n_pads == 0:
            chunks = [()] * steps
        else:
            xs = self._ingest_all(ext_inputs)
            n = xs[0].shape[1]
            cs = self.chunk_size
            nchunks = -(-n // cs)
            pad_to = nchunks * cs
            if pad_to != n:
                xs = [torch.cat([x, x.new_zeros(
                    (x.shape[0], pad_to - n) + tuple(x.shape[2:]))], dim=1)
                      for x in xs]
            chunks = [tuple(x[:, c * cs:(c + 1) * cs] for x in xs)
                      for c in range(nchunks)]
        if device_loop:
            self._check_versions()
            if self._loop is None:
                self._loop = (_ChannelLoops(self) if self._chan_loops
                              else _MeshLoop(self))
            self._loop.load()
            step = self._loop.step
        else:
            step = self.step
        outs_accum: List[List] = [[] for _ in self.flat.out_pads]
        sink_accum: Dict[str, List] = {}
        counts_accum: List[Dict[str, np.ndarray]] = []
        tag_chunks = []
        for chunk in chunks:
            if device_loop:
                pads, caps, tagrecs = step(*chunk)
                tag_chunks.append(tagrecs)
            else:
                pads, caps = step(*chunk)
            for i, v in enumerate(pads):
                outs_accum[i].append(v)
            for name, vals in caps.items():
                if name == "__vr_counts__":
                    counts_accum.append(vals)
                else:
                    sink_accum.setdefault(name, []).append(vals)
        if device_loop:
            self._loop.unload()
            for tagrecs in tag_chunks:
                self._advance_mesh_tags(tagrecs)
        return self._mesh_finalize(outs_accum, sink_accum, n, counts_accum)

    def _compact_chan(self, owner: Block, parts, counts_accum):
        """Per-channel emission compaction: each step's buffer is
        (nchannels, rows, items, ...) with that step's per-channel valid
        row counts; returns a list of per-channel streams."""
        out = []
        for c in range(self.nchannels):
            parts_c = [p[c] for p in parts]
            counts_c = [{owner.name: int(cc[owner.name][c])}
                        for cc in counts_accum]
            out.append(self._compact_emissions(owner, parts_c, counts_c))
        return out

    def _mesh_finalize(self, outs_accum, sink_accum, n_in, counts_accum):
        pad_outs = []
        for i, parts in enumerate(outs_accum):
            if i in self._pad_emit_key:
                owner = self._emit_specs[self._pad_emit_key[i]][3]
                pad_outs.append(self._compact_chan(owner, parts, counts_accum))
                continue
            full = torch.cat(parts, dim=1) if parts else None
            if n_in is not None and full is not None:
                r = self._cumulative_rate(self.out_pad_edges[i])
                full = full[:, :int(n_in * r)]
            pad_outs.append(full)
        self.sink_data = {}
        byname = {b.name: b for b in self.order}
        for name, vals in sink_accum.items():
            b = byname[name]
            owner = self.block_owner[b.uid]
            if owner is not None:
                self.sink_data[name] = tuple(
                    self._compact_chan(owner, [v[j] for v in vals],
                                       counts_accum)
                    for j in range(len(vals[0])))
                continue
            exact = None
            if n_in is not None:
                exact = int(n_in * self._cumulative_rate(self._ups[b.uid][0]))
            self.sink_data[name] = tuple(
                torch.cat([v[j] for v in vals], dim=1)[:, :exact]
                for j in range(len(vals[0])))
        for name, vals in self.sink_data.items():
            byname[name].captured = vals
        if len(pad_outs) == 1:
            return pad_outs[0]
        return tuple(pad_outs)


class _MeshLoop:
    """``run(device_loop=True)`` for a fixed-rate graph without tag
    emitters: the whole mesh step over static buffers (each channel's
    state, one chunk of each input pad, the joined outputs), called through
    one ``StepGraph``: on a card, captured at its second call and replayed
    after, so that one replay runs every channel and shard and the copies
    between them."""

    def __init__(self, mex: MeshExecutor):
        from grtpu_torch.runtime.step_graph import StepGraph

        for b in mex.order:
            if b.host_only:
                raise ValueError(
                    f"device_loop: {b.name} ({type(b).__name__}) runs its "
                    "work on the host, which a captured step cannot do; "
                    "run this graph with run() or step()")
        devices = {d for d in mex.mesh.devices.flat}
        if len(devices) > 1 and any(d.type == "cuda" for d in devices):
            raise ValueError(
                "device_loop captures the mesh step on one card; this mesh "
                f"spans {sorted(map(str, devices))}: run it without "
                "device_loop")
        self.mex = mex
        self.chans = None
        self.inputs = None
        self.outs = None
        self.graph = StepGraph(self._body, mex.device)

    def load(self):
        from grtpu_torch.runtime.device_loop import _clone_tree, _commit

        if self.chans is None:
            self.chans = [_clone_tree(s) for s in self.mex._chans]
            return
        _commit([(d, v) for mine, st in zip(self.chans, self.mex._chans)
                 for (_, d), (_, v) in zip(_leaves(mine), _leaves(st))])

    def unload(self):
        from grtpu_torch.runtime.device_loop import _clone_tree

        self.mex._chans = [_clone_tree(s) for s in self.chans]

    def _body(self):
        from grtpu_torch.runtime.device_loop import _commit

        mex = self.mex
        shards = mex._shard_inputs(self.inputs)
        results, pairs = [], []
        for c in range(mex.nchannels):
            st, res = mex._chan_step(c, self.chans[c], shards[c])
            pairs += [(d, v) for (_, d), (_, v) in zip(_leaves(self.chans[c]),
                                                       _leaves(st))]
            results.append(res)
        if self.outs is None:          # the first, eager call sets the layout
            pads, caps, _ = mex._assemble(results)
            self.outs = (list(pads), {k: list(v) for k, v in caps.items()})
        else:
            mex._assemble(results, self.outs)
        _commit(pairs)

    def step(self, *chunk):
        if self.inputs is None:
            self.inputs = tuple(torch.empty_like(x) for x in chunk)
        for buf, x in zip(self.inputs, chunk):
            buf.copy_(x)
        self.graph()
        pads = tuple(p.clone() for p in self.outs[0])
        caps = {k: tuple(v.clone() for v in vals)
                for k, vals in self.outs[1].items()}
        return pads, caps, [({}, {})] * self.mex.nchannels


class _ChannelLoops:
    """``run(device_loop=True)`` for a graph with variable-rate blocks or
    tag emitters: one ``DeviceLoop`` a channel, on its column's device."""

    def __init__(self, mex: MeshExecutor):
        from grtpu_torch.runtime.device_loop import DeviceLoop

        self.mex = mex
        self.loops = [DeviceLoop(mex._lane(mex._home(c)))
                      for c in range(mex.nchannels)]

    def load(self):
        self.steps = [dl.load(st) for dl, st in zip(self.loops, self.mex._chans)]

    def unload(self):
        self.mex._chans = [dl.unload() for dl in self.loops]

    def step(self, *chunk):
        results = []
        for c, step in enumerate(self.steps):
            pads, caps = step(*(x[c].to(self.loops[c].device) for x in chunk))
            caps = {k: v if k.startswith("__") else tuple([u] for u in v)
                    for k, v in caps.items()}
            results.append(([[p] for p in pads], caps))
        return self.mex._assemble(results)
