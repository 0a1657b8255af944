"""The device mesh of grtpu_torch's parallel layer, driven by one process.

grtpu lays its multi-device programs over a ``jax.sharding.Mesh``: one
controller runs a per-shard function under ``shard_map``, and the shards
talk through ``ppermute``, ``psum`` and ``all_gather`` inside it.  The port
keeps that model with plain torch devices (this module has no counterpart
in grtpu):

* :class:`Mesh` is an n-d array of ``torch.device`` s with named axes, such
  as ``("time", "chan")``.  An entry may repeat a device: four entries of
  ``cuda:0`` are four logical shards on one card, and N entries of ``cpu``
  are the CPU tests' mesh (grtpu's tests fake N devices with
  ``--xla_force_host_platform_device_count``).
* :func:`shard` and :func:`unshard` are ``device_put`` with a
  ``NamedSharding`` and its inverse: a global tensor split by a partition
  spec (:class:`P`) into one tensor per mesh entry, and joined back.
* A per-shard program is written for all shards at once.  It holds one
  value per mesh entry, a numpy object array of the mesh's shape (what
  :func:`shard` returns; :func:`local_map` applies a function entry by
  entry), and calls the collectives between its steps: :func:`axis_index`,
  :func:`ppermute` (each shard's tensor copied to its peer's device),
  :func:`psum` and :func:`all_gather`.

Why one process drives every shard, and not one process per device with
``torch.distributed``: NCCL runs one rank a card, so a machine with one
card could run only a world of one, and no halo exchange, shard-serial
chain or collective would ever run on it.  With one controller over
logical shards the card runs every one of them; on a machine with several
cards the same code puts the shards on ``cuda:0..N-1`` and copies peer to
peer.  ``torch.distributed`` carries only what crosses processes: a mesh
may say which process owns each entry (``processes``); an entry of another
process holds ``None`` here, and on a mesh that spans processes every
collective goes through ``torch.distributed`` (gloo on the CPU, NCCL
between cards; :mod:`grtpu_torch.parallel.multihost` starts it), called by
every process in the same order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from grtpu_torch.utils.device import resolve


class P(tuple):
    """A partition spec: for each leading dimension of a tensor, the mesh
    axis it is split over (a name, or a tuple of names split in that
    order), or None (kept whole).  A tensor is replicated over every mesh
    axis its spec does not name.  ``P("chan", "time")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """An n-d array of torch devices with named axes.

    Args:
      devices: a nested sequence (or array) of devices or device strings;
        its shape is the mesh's shape.  Entries may repeat a device.
      axis_names: one name per axis.
      processes: for each entry, the rank of the process that owns it;
        every entry is this process's when not given.
    """

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.ravel()]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        if processes is None:
            processes = np.full(self.devices.shape, _rank())
        self.processes = np.asarray(processes, dtype=np.int64).reshape(
            self.devices.shape)

    @property
    def size(self) -> int:
        return self.devices.size

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def entries(self) -> List[tuple]:
        """Every entry's index, in C order."""
        return list(np.ndindex(*self.devices.shape))

    def is_local(self, idx) -> bool:
        return int(self.processes[idx]) == _rank()

    @property
    def spans_processes(self) -> bool:
        return bool((self.processes != _rank()).any())

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self.devices.flat})})")


def time_chan_mesh(n: int, devices=None, time: int | None = None) -> Mesh:
    """2-D ``("time", "chan")`` mesh of ``devices[:n]`` (n logical shards on
    the card when not given); degenerate axes allowed.  ``time`` fixes the
    time axis's size; by default a modest time axis (4 or 2) with at least
    2 channel shards, else pure channel sharding."""
    if devices is None:
        devices = [resolve(None)] * n
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"{n} mesh entries asked of {len(devices)} devices")
    if time is None:
        time = 1
        for cand in (4, 2):
            if n % cand == 0 and n // cand >= 2:
                time = cand
                break
    if n % time:
        raise ValueError(f"time={time} does not divide {n} devices")
    dev = np.empty(n, dtype=object)
    dev[:] = devices[:n]
    return Mesh(dev.reshape(time, n // time), ("time", "chan"))


# ------------------------------------------------------------------ layout
def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_slices(mesh: Mesh, spec: P, shape: Sequence[int], idx) -> tuple:
    """The slices of a global tensor of ``shape`` that mesh entry ``idx``
    holds under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        axes = _axes_of(spec[d]) if d < len(spec) else ()
        parts, k = 1, 0
        for a in axes:
            ai = mesh.axis(a)
            k = k * mesh.devices.shape[ai] + idx[ai]
            parts *= mesh.devices.shape[ai]
        if n % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} is not "
                             f"divisible by the {parts} shards of {axes}")
        sz = n // parts
        out.append(slice(k * sz, (k + 1) * sz))
    return tuple(out)


def shard(x, mesh: Mesh, spec: P, dtype=None) -> np.ndarray:
    """Split a global tensor (or numpy array) over the mesh: one tensor per
    local entry, on that entry's device; None for another process's."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.entries():
        if mesh.is_local(idx):
            part = x[entry_slices(mesh, spec, x.shape, idx)]
            out[idx] = part.to(device=mesh.devices[idx], dtype=dtype)
    return out


def unshard(parts: np.ndarray, mesh: Mesh, spec: P, device=None) -> torch.Tensor:
    """Join per-entry tensors laid out by ``spec`` into the global tensor
    on ``device`` (the mesh's first device when not given).  Replicated
    entries are taken at coordinate 0 of the axes the spec does not name."""
    if any(parts[idx] is None for idx in mesh.entries()):
        raise ValueError("unshard needs every entry: this mesh spans "
                         "processes")
    device = mesh.devices.flat[0] if device is None else torch.device(device)
    first = parts.flat[0]
    named = {a for e in spec for a in _axes_of(e)}
    shape = list(first.shape)
    for d in range(len(spec)):
        for a in _axes_of(spec[d]):
            shape[d] *= mesh.shape[a]
    out = torch.empty(shape, dtype=first.dtype, device=device)
    for idx in mesh.entries():
        if any(idx[mesh.axis(a)] for a in mesh.axis_names if a not in named):
            continue
        out[entry_slices(mesh, spec, shape, idx)] = parts[idx].to(device)
    return out


def local_map(fn: Callable, mesh: Mesh, *parts) -> np.ndarray:
    """``fn(*values)`` at every local entry of ``mesh``, where a part is a
    per-entry object array (taken entry by entry) or any other value (the
    same for every entry); None at another process's entries."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.entries():
        if mesh.is_local(idx):
            out[idx] = fn(*(p[idx] if isinstance(p, np.ndarray)
                            and p.dtype == object else p for p in parts))
    return out


def axis_index(mesh: Mesh, axis: str, idx) -> int:
    """Entry ``idx``'s coordinate on ``axis`` (``lax.axis_index``)."""
    return int(idx[mesh.axis(axis)])


def _groups(mesh: Mesh, axes: Sequence[str]) -> List[List[tuple]]:
    """The entries that differ only on ``axes``, one list a group, each in
    C order over ``axes``."""
    ax = [mesh.axis(a) for a in axes]
    rest = [i for i in range(mesh.devices.ndim) if i not in ax]
    groups: Dict[tuple, List[tuple]] = {}
    for idx in mesh.entries():
        key = tuple(idx[i] for i in rest)
        groups.setdefault(key, []).append(idx)
    for g in groups.values():
        g.sort(key=lambda e: tuple(e[i] for i in ax))
    return [groups[k] for k in sorted(groups)]


# ------------------------------------------------------------- collectives
def _comm_device(mesh: Mesh, parts) -> torch.device:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "this mesh spans processes, and torch.distributed is not "
            "initialized: call grtpu_torch.parallel.multihost."
            "init_distributed first")
    if dist.get_backend() == "nccl":
        return next(parts[idx].device for idx in mesh.entries()
                    if mesh.is_local(idx))
    return torch.device("cpu")


def _template(mesh: Mesh, parts) -> torch.Tensor:
    return next(parts[idx] for idx in mesh.entries() if mesh.is_local(idx))


def ppermute(parts: np.ndarray, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> np.ndarray:
    """``lax.ppermute``: along ``axis``, each pair ``(src, dst)`` of
    coordinates sends entry src's tensor to entry dst's device; an entry
    that receives nothing gets zeros.  Between processes, a send and a
    receive of ``torch.distributed``."""
    out = np.empty(mesh.devices.shape, dtype=object)
    dests = {d for _, d in perm}
    ops, recvd = [], []
    for g in _groups(mesh, (axis,)):
        for s, d in perm:
            src, dst = g[s], g[d]
            if mesh.is_local(src) and mesh.is_local(dst):
                out[dst] = parts[src].to(mesh.devices[dst])
            elif mesh.is_local(src) or mesh.is_local(dst):
                import torch.distributed as dist

                dev = _comm_device(mesh, parts)
                if mesh.is_local(src):
                    ops.append(dist.P2POp(dist.isend,
                                          parts[src].contiguous().to(dev),
                                          int(mesh.processes[dst])))
                else:
                    buf = torch.empty_like(parts[dst], device=dev)
                    ops.append(dist.P2POp(dist.irecv, buf,
                                          int(mesh.processes[src])))
                    recvd.append((dst, buf))
        for i, idx in enumerate(g):
            if i not in dests and mesh.is_local(idx):
                out[idx] = torch.zeros_like(parts[idx])
    if ops:
        import torch.distributed as dist

        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for dst, buf in recvd:
            out[dst] = buf.to(mesh.devices[dst])
    return out


def _reduce_groups(parts, mesh, groups, fill) -> List[torch.Tensor]:
    """For each group, ``fill(group, local entries)``'s tensor summed over
    the processes (one ``all_reduce``), or as it is on a mesh of this
    process alone."""
    vals = [fill(g, [e for e in g if mesh.is_local(e)]) for g in groups]
    if not mesh.spans_processes:
        return vals
    import torch.distributed as dist

    dev = _comm_device(mesh, parts)
    buf = torch.stack([v.to(dev) for v in vals])
    dist.all_reduce(buf)
    return list(buf.unbind(0))


def psum(parts: np.ndarray, mesh: Mesh, axes) -> np.ndarray:
    """``lax.psum`` over one axis name or a tuple of them: every entry gets
    the sum of its group's tensors, on its own device.  Within a process
    the sum runs in the group's order; across processes each process adds
    its entries and one ``all_reduce`` adds the processes."""
    axes = _axes_of(axes)
    groups = _groups(mesh, axes)
    tmpl = _template(mesh, parts)

    def fill(g, local):
        if not local:
            return torch.zeros_like(tmpl)
        acc = parts[local[0]]
        for e in local[1:]:
            acc = acc + parts[e].to(acc.device)
        return acc

    sums = _reduce_groups(parts, mesh, groups, fill)
    out = np.empty(mesh.devices.shape, dtype=object)
    for g, total in zip(groups, sums):
        for e in g:
            if mesh.is_local(e):
                out[e] = total.to(mesh.devices[e])
    return out


def all_gather(parts: np.ndarray, mesh: Mesh, axis: str) -> np.ndarray:
    """``lax.all_gather``: every entry gets its group's tensors stacked
    along a new leading axis in the order of ``axis``.  Across processes,
    each process writes its entries into a zero buffer and one
    ``all_reduce`` joins them (every slot has one writer)."""
    groups = _groups(mesh, (axis,))
    tmpl = _template(mesh, parts)

    def fill(g, local):
        dev = parts[local[0]].device if local else tmpl.device
        if len(local) == len(g):
            return torch.stack([parts[e].to(dev) for e in g])
        buf = torch.zeros((len(g),) + tuple(tmpl.shape), dtype=tmpl.dtype,
                          device=dev)
        for i, e in enumerate(g):
            if mesh.is_local(e):
                buf[i] = parts[e]
        return buf

    stacks = _reduce_groups(parts, mesh, groups, fill)
    out = np.empty(mesh.devices.shape, dtype=object)
    for g, st in zip(groups, stacks):
        for e in g:
            if mesh.is_local(e):
                out[e] = st.to(mesh.devices[e])
    return out


# ------------------------------------------------------------------- trees
def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a tree of tensors, tuples, lists and
    dicts (NamedTuples kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_stack(trees: Sequence, device=None):
    """Trees of one structure stacked leaf by leaf on a new leading axis
    (each leaf on ``device``, or where the first tree's leaf lies)."""
    leaves = [tree_leaves(t) for t in trees]
    it = iter(range(len(leaves[0])))

    def stack(first):
        i = next(it)
        dev = first.device if device is None else device
        return torch.stack([lv[i].to(dev) for lv in leaves])

    return tree_map(stack, trees[0])
