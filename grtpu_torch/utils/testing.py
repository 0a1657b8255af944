"""Test helpers — the gr_unittest analog.

Port of ``grtpu.utils.testing``: tolerance-based tuple comparisons
(assertComplexTuplesAlmostEqual / assertFloatTuplesAlmostEqual), an SNR
metric, and the run-a-tiny-graph helper of the reference's QA pattern
(vector_source -> block -> vector_sink -> compare).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def assert_float_tuples_almost_equal(a, b, places: int = 7):
    np.testing.assert_allclose(np.asarray(_host(a), np.float64),
                               np.asarray(_host(b), np.float64),
                               atol=10.0 ** (-places), rtol=0)


def assert_complex_tuples_almost_equal(a, b, places: int = 7):
    np.testing.assert_allclose(np.asarray(_host(a), np.complex128),
                               np.asarray(_host(b), np.complex128),
                               atol=10.0 ** (-places), rtol=0)


def snr_db(reference, estimate) -> float:
    """Output-fidelity metric for 'bit-exact within SNR bound' checks."""
    ref = np.asarray(_host(reference), np.float64)
    err = np.asarray(_host(estimate), np.float64) - ref
    return float(10 * np.log10(
        max((np.abs(ref) ** 2).sum(), 1e-300)
        / max((np.abs(err) ** 2).sum(), 1e-300)))


def run_block(block, *inputs, chunk_size=None, device=None):
    """The reference's QA idiom in one call: vector_source(s) -> block ->
    vector_sink(s) on ``device`` (the card unless named); returns the output
    array(s) as numpy."""
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.runtime.executor import StreamExecutor
    from grtpu_torch.runtime.graph import Graph

    g = Graph()
    n = len(_host(inputs[0]))
    if chunk_size is None:
        chunk_size = n
    for i, port in enumerate(block.in_ports):
        g.connect(g.add_input(Port(port.dtype, port.vlen)), (block, i))
    for i, port in enumerate(block.out_ports):
        g.connect((block, i), g.add_output(Port(port.dtype, port.vlen)))
    ex = StreamExecutor(g, chunk_size=chunk_size, device=device)
    res = ex.run(*inputs)
    if len(block.out_ports) == 1:
        return _host(res)
    return tuple(_host(r) for r in res)
