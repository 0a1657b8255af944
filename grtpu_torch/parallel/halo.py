"""Halo exchange: shard-boundary state transfer over the device mesh.

Port of ``grtpu.parallel.halo``.  The replacement for the reference's
buffer-reader history preload (gr_buffer nzero_preload,
gr_flat_flowgraph.cc:124-152) when a stream's time axis is split over
shards: each shard needs the last ``halo`` samples of its left neighbour
before filtering, the overlap-save boundary of SURVEY.md §5.7, delivered by
:func:`grtpu_torch.parallel.mesh.ppermute` (a copy to the neighbour's
device).  grtpu's functions run inside ``shard_map``; these take and return
one tensor per mesh entry (an object array of the mesh's shape, as
:func:`grtpu_torch.parallel.mesh.shard` makes it).
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.parallel.mesh import Mesh, axis_index, local_map, ppermute


def ring_halo_left(x: np.ndarray, mesh: Mesh, axis_name: str, halo: int,
                   axis: int = 0, wrap: bool = False) -> np.ndarray:
    """Prepend each shard with the trailing ``halo`` samples of its left
    neighbour along mesh axis ``axis_name``.

    The first shard receives zeros unless ``wrap`` (zero preload, the
    reference's history initialization).  Each shard grows by ``halo`` on
    ``axis``."""
    if halo == 0:
        return x
    n = mesh.shape[axis_name]
    tail = local_map(lambda v: v.narrow(axis, v.shape[axis] - halo, halo),
                     mesh, x)
    recv = ppermute(tail, mesh, axis_name, [(i, (i + 1) % n) for i in range(n)])
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in mesh.entries():
        if not mesh.is_local(idx):
            continue
        r = recv[idx]
        if not wrap and axis_index(mesh, axis_name, idx) == 0:
            r = torch.zeros_like(r)
        out[idx] = torch.cat([r, x[idx]], dim=axis)
    return out


def shard_fir_filter(x_local: np.ndarray, taps, mesh: Mesh, axis_name: str,
                     decim: int = 1, time_axis: int = -1) -> np.ndarray:
    """Time-sharded FIR: halo-exchange K-1 samples, then each shard's local
    FIR (``grtpu_torch.ops.fir.fir_filter``).

    ``x_local``: each shard's samples, time on ``time_axis`` (the last
    axis; leading axes are batch axes).  Each shard's output is its local
    length // decim (the local length must be a multiple of decim: shard
    boundaries land on decimation boundaries, as the executor's chunk rule
    requires)."""
    from grtpu_torch.ops.fir import fir_filter

    k = int(np.shape(taps)[0])
    ndim = next(v.dim() for v in x_local.flat if v is not None)
    ta = time_axis % ndim
    if ta != ndim - 1:
        raise NotImplementedError("time axis must be the last axis")
    xh = ring_halo_left(x_local, mesh, axis_name, k - 1, axis=ta)
    return local_map(lambda v: fir_filter(v, taps, decim), mesh, xh)
