"""Graph-level optimization passes (port of ``grtpu.runtime.optimize``).

Algebraic fusion of adjacent LTI FIR stages: chained convolutions collapse
into one convolution with the composed impulse response
(:func:`grtpu_torch.ops.fir.compose_taps`), so the window cost of a Toeplitz
product is paid once instead of per stage and a step launches fewer
kernels.  Composition is exact in exact arithmetic; in float the composed
filter differs from the chained evaluation by reassociation only.

``FirFilter`` is imported inside the pass, so the runtime imports nothing
from ``grtpu_torch.blocks`` when it is loaded.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from grtpu_torch.runtime.graph import Edge, Endpoint, FlatGraph


def _fusable_pair(flat: FlatGraph, a, b, fir_filter) -> bool:
    """a -> b where both are plain decim-capable FirFilters, a does not
    decimate (composition across a rate change needs polyphase algebra),
    a's output feeds ONLY b, and the stream dtypes line up."""
    if type(a) is not fir_filter or type(b) is not fir_filter:
        return False
    if a.decim != 1:
        return False
    if len(flat.downstream_of(a)) != 1:
        return False
    return a.out_ports[0].dtype == b.in_ports[0].dtype


def fuse_fir_chains(flat: FlatGraph) -> FlatGraph:
    """Collapse chains of adjacent FirFilter blocks into single composed
    filters.  Returns a new FlatGraph (blocks may be replaced); history
    and rates are recomputed by the replacement block's constructor.

    The composed block, named ``"{a.name}+{b.name}"``, inherits the
    downstream filter's decimation and output signature; its impl resolves
    through FirFilter's auto rule, so long composed filters route to the FFT
    path, as in grtpu.
    """
    from grtpu_torch.blocks.filter import FirFilter
    from grtpu_torch.ops.fir import compose_taps

    edges = list(flat.edges)
    changed = True
    while changed:
        changed = False
        for e in edges:
            a, bdst = e.src.block, e.dst.block
            if not isinstance(a, FirFilter) or not isinstance(bdst, FirFilter):
                continue
            if not _fusable_pair(FlatGraph(flat.name, edges, flat.in_pads,
                                           flat.out_pads), a, bdst, FirFilter):
                continue
            taps = compose_taps(a.taps, bdst.taps)
            in_t = "c" if a.in_ports[0].dtype == torch.complex64 else "f"
            out_t = "c" if bdst.out_ports[0].dtype == torch.complex64 else "f"
            tap_t = "c" if np.iscomplexobj(taps) else "f"
            fused = FirFilter(bdst.decim, taps, in_t + out_t + tap_t,
                              name=f"{a.name}+{bdst.name}")
            new_edges: List[Edge] = []
            for e2 in edges:
                if e2 is e:
                    continue  # the fused-away internal edge
                src, dst = e2.src, e2.dst
                if src.block is bdst or src.block is a:
                    src = Endpoint(fused, src.port)
                if dst.block is a or dst.block is bdst:
                    dst = Endpoint(fused, dst.port)
                new_edges.append(Edge(src, dst))
            edges = new_edges
            changed = True
            break
    out = FlatGraph(flat.name, edges, flat.in_pads, flat.out_pads)
    out.validate()
    return out
