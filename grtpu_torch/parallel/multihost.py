"""Multi-process deployment: distributed start-up and per-process ingest.

Port of ``grtpu.parallel.multihost``.  The reference's only inter-host
transport is raw UDP datagrams carrying samples (gr_udp_source/sink,
SURVEY.md §5.8).  Here every process ingests ITS OWN slice of the stream
(its antenna feed, its capture file, its UDP socket) onto the mesh entries
it owns, and the collectives between entries of different processes go
through ``torch.distributed`` (:mod:`grtpu_torch.parallel.mesh`: gloo on the
CPU, NCCL between cards).

Pieces:
  * :func:`init_distributed` — ``torch.distributed.init_process_group``
    with torch's own environment defaults (one call a process, first);
  * :func:`host_shard_spec` — which slice of the global (chan, time) stream
    this process must ingest;
  * :func:`feed_from_host` — this process's slice onto its own entries;
  * :func:`udp_ingest_step` — the drop-in gr_udp_source replacement: each
    process's UDP source fills its entries between steps.

With one process (the tests' default, and a machine with one card) every
entry is this process's and everything stays local: the same code path
with no collective crossing a process.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from grtpu_torch.parallel.mesh import Mesh, P, entry_slices
from grtpu_torch.utils.device import resolve


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> None:
    """Start ``torch.distributed`` (a no-op for one process).

    Defaults are torch's own environment variables: ``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` through the ``env://``
    init method (grtpu reads ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID`` and
    ``JAX_COORDINATOR_ADDRESS``).  ``init_method`` may name the rendezvous
    itself, e.g. ``tcp://localhost:29500``.  The backend follows the
    process's device (the card when not given): NCCL on a card, gloo on
    the CPU."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    import torch.distributed as dist

    backend = "nccl" if resolve(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


@functools.lru_cache(maxsize=64)
def host_shard_spec(mesh: Mesh, spec: P,
                    global_shape: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The slice of the global array that this process's entries hold.

    Use it to know which channels and which time segment to ingest here
    (each process reads only its own feed).  Cached per (mesh, spec,
    shape): it sits in the per-chunk ingest loop."""
    lo = list(global_shape)
    hi = [0] * len(global_shape)
    for idx in mesh.entries():
        if not mesh.is_local(idx):
            continue
        for a, s in enumerate(entry_slices(mesh, spec, global_shape, idx)):
            lo[a] = min(lo[a], s.start)
            hi[a] = max(hi[a], s.stop)
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def feed_from_host(mesh: Mesh, spec: P, local_np: np.ndarray,
                   global_shape: Tuple[int, ...]) -> np.ndarray:
    """This process's slice of the global stream onto its entries.

    ``local_np`` must be exactly the :func:`host_shard_spec` slice of the
    global array.  Returns one tensor per mesh entry (None at another
    process's entries), each on its entry's device: no sample crosses a
    process."""
    base = host_shard_spec(mesh, spec, tuple(global_shape))
    local = np.ascontiguousarray(local_np)
    if not local.flags.writeable:       # e.g. a datagram buffer
        local = local.copy()
    local = torch.from_numpy(local)
    want = tuple(s.stop - s.start for s in base)
    if tuple(local.shape) != want:
        raise ValueError(f"this process's slice is {want}, got "
                         f"{tuple(local.shape)}")
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.entries():
        if mesh.is_local(idx):
            sl = entry_slices(mesh, spec, global_shape, idx)
            rel = tuple(slice(s.start - b.start, s.stop - b.start)
                        for s, b in zip(sl, base))
            out[idx] = local[rel].to(mesh.devices[idx])
    return out


def udp_ingest_step(mesh: Mesh, spec: P, source, n_items: int,
                    global_shape: Tuple[int, ...]) -> Optional[np.ndarray]:
    """One gr_udp_source-replacement ingest step: pull this process's chunk
    from ``source`` (any object with ``read_items(n)`` returning a flat
    array: ``grtpu_torch.io.udp.UdpSource`` or ``native_udp_source``) and
    put it on this process's entries (:func:`feed_from_host`); None at
    EOF."""
    local = source.read_items(n_items)
    if local is None:
        return None
    if isinstance(local, tuple):
        raise TypeError(
            "udp_ingest_step needs a single-plane source; sc16 planar "
            "sources return (re, im): feed the planes separately")
    sl = host_shard_spec(mesh, spec, tuple(global_shape))
    local = np.asarray(local).reshape([s.stop - s.start for s in sl])
    return feed_from_host(mesh, spec, local, global_shape)
