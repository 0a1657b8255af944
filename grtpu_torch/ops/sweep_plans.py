"""Time the launch plans of the Hopper FIR kernels side by side on the card.

    python -m grtpu_torch.ops.sweep_plans

``cuda_fir`` picks one launch plan per shape (``_decim_mma_plan``,
``_decim_fma_plan``, ``_cascade_plan``).  This script forces the others on
the same inputs, at the shapes ``chip_smoke.py`` reports, and prints each
plan's time with the chosen plan marked, so that the constants in those
functions can be held against the card they run on:

* the WBFM bank (64 x 2^18, 155 taps, decimate by 8): the tensor-core route
  over tiles a block (``mtb``) and tiles a block walks (``tpb``) in bf16x3
  and bf16, the FMA route over phase groups (``kp``) and ``tpb`` in f32 and
  bf16x3;
* the WBFM chunk (1 x 65,536, 193 taps, decimate by 8, bf16x3): the
  tensor-core route over outputs a block (``to``), and the FMA route;
* the two decimating routes at 64 x 2^15 outputs, decimations 2 to 16 and 16
  to 256 taps in bf16 and bf16x3, with the route ``cuda_fir._route`` takes;
* the f32 cascade (16 x 2^20, 16 stages of 256 taps): tile and threads.

The decimating rows are replayed from a CUDA graph of 20 launches (the
card's time without the host's launch cost), the cascade is timed with CUDA
events over 3 launches.  Needs a CUDA device and nvcc.

    python -m grtpu_torch.ops.sweep_plans --host-cost

prints only what one ``fir_decim`` call at the chunk's shape costs the host
(batches of 1,000 calls on the host clock, no synchronize between calls).  It
uses the public API alone, so run by path with ``PYTHONPATH`` set to another
checkout (``PYTHONPATH=other python grtpu_torch/ops/sweep_plans.py
--host-cost``) it times that checkout's wrapper.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from grtpu_torch.ops import _build, cuda_fir as cf
from grtpu_torch.utils import firdes


TPBS = (1, 2, 3, 4, 6, 8, 13, 16)     # tiles a block walks, swept


def cuda_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def decim_rows(lib, name, x, taps, d, nout, precision, label, plans, chosen):
    """One line per plan of a decimating kernel on (x, taps)."""
    b, total = x.shape
    g, k = taps.shape
    head = (b, total, g, k, d, 0, nout, cf._PRECISION_CODE[precision])
    for plan in plans:
        launch = cf._Plan(name, getattr(lib, name), head + plan)
        ms = graph_ms(lambda: cf._launch_tile(x, taps, d, 0, nout, precision,
                                              _plan=launch))
        mark = "  <- chosen" if plan == chosen else ""
        print(f"{label} {name} {precision} plan={plan}: {ms:.4f} ms{mark}",
              flush=True)


def host_cost(batches: int = 5, calls: int = 1000):
    """Host microseconds of one ``fir_decim`` call at the WBFM chunk (1 x
    65,536, 193 taps, decimate by 8, bf16x3), per batch of ``calls``."""
    dev = torch.device("cuda")
    taps = torch.from_numpy(firdes.low_pass(
        1.0, 256e3, 15e3, 3.2e3, firdes.Window.HAMMING).astype(np.float32)).to(dev)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 65536 + len(taps) - 1).astype(np.float32)).to(dev)
    cf.fir_decim(x, taps, 8, precision="bf16x3")
    out = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            cf.fir_decim(x, taps, 8, precision="bf16x3")
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    print(f"host cost fir_decim 1x65536 K{len(taps)} d8 bf16x3 "
          f"({cf.__file__}): median {np.median(out):.2f} us per call, batches "
          f"of {calls}: {' '.join(f'{v:.2f}' for v in out)}", flush=True)


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if "--host-cost" in sys.argv[1:]:
        return host_cost()
    lib = _build.library()
    sms = cf._sm_count(0)
    rng = np.random.RandomState(0)

    # the WBFM bank
    taps155 = cf._tapsets(firdes.low_pass(1.0, 256e3, 15e3, 4e3), dev)
    k, d, nout = taps155.shape[1], 8, 1 << 15
    x = torch.from_numpy(rng.randn(64, nout * d + k - 1).astype(np.float32)).to(dev)
    for precision in ("bf16x3", "bf16"):
        decim_rows(lib, "fir_decim_mma_fwd", x, taps155, d, nout, precision,
                   "bank (mtb, to, tpb)",
                   [(mtb, 128 * mtb, tpb) for mtb in (4, 2, 1)
                    for tpb in TPBS],
                   cf._decim_mma_plan(precision, d, k, 64, nout, sms))
    for precision in ("f32", "bf16x3"):
        decim_rows(lib, "fir_decim_fwd", x, taps155, d, nout, precision,
                   "bank (kp, tpb)",
                   [(kp, tpb) for kp in (4, 2, 1) for tpb in TPBS],
                   cf._decim_fma_plan(precision, d, k, 64, nout, sms))
    del x

    # the WBFM chunk
    taps193 = cf._tapsets(firdes.low_pass(1.0, 256e3, 15e3, 3.2e3,
                                          firdes.Window.HAMMING), dev)
    k, nout = taps193.shape[1], 8192
    x = torch.from_numpy(rng.randn(1, nout * d + k - 1).astype(np.float32)).to(dev)
    decim_rows(lib, "fir_decim_mma_fwd", x, taps193, d, nout, "bf16x3",
               "chunk (mtb, to, tpb)",
               [(1, 32, 1), (1, 56, 1), (1, 64, 1), (1, 128, 1), (2, 256, 1)],
               cf._decim_mma_plan("bf16x3", d, k, 1, nout, sms))
    decim_rows(lib, "fir_decim_fwd", x, taps193, d, nout, "bf16x3",
               "chunk (kp, tpb)", [(4, 1), (2, 1), (1, 1)],
               cf._decim_fma_plan("bf16x3", d, k, 1, nout, sms))
    del x

    # the two decimating routes side by side, 64 x 2^15 outputs
    xr = torch.from_numpy(rng.randn(64, (1 << 15) * 16 + 255)
                          .astype(np.float32)).to(dev)
    nout = 1 << 15
    for d in (2, 3, 4, 8, 16):
        for k in (16, 32, 64, 128, 256):
            tk = cf._tapsets(np.random.RandomState(k).randn(k) / k, dev)
            xs = xr[:, :nout * d + k - 1].contiguous()
            for precision in ("bf16", "bf16x3"):
                launch = cf._Plan(
                    "fir_decim_mma_fwd", lib.fir_decim_mma_fwd,
                    (64, xs.shape[1], 1, k, d, 0, nout,
                     cf._PRECISION_CODE[precision])
                    + cf._decim_mma_plan(precision, d, k, 64, nout, sms))
                tensor = graph_ms(lambda: cf._launch_tile(
                    xs, tk, d, 0, nout, precision, _plan=launch))
                fma = graph_ms(lambda: cf._launch_tile(
                    xs, tk, d, 0, nout, precision, _fma=True))
                print(f"routes 64x2^15 outputs d{d} K{k} {precision}: "
                      f"tensor_ms={tensor:.4f} fma_ms={fma:.4f} "
                      f"takes {cf._route(precision, d, k, 64, nout)}",
                      flush=True)
    del xr, xs

    # the f32 cascade
    taps256 = torch.from_numpy((np.random.RandomState(0).randn(256) * 0.05)
                               .astype(np.float32)).to(dev)
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 1 << 20)
                         .astype(np.float32)).to(dev)
    chosen = cf._cascade_plan(1 << 20, 256, 16, "f32", 16, sms)
    plans = [(tile, threads)
             for tile in (4096, 8192, 12288, 16384, 18432, 20480, 21504)
             for threads in (256, 512, 1024)]
    for plan in plans + ([] if chosen in plans else [chosen]):
        ms = cuda_ms(lambda: cf._launch_cascade(x, taps256, 16, "f32",
                                                _plan=plan), 3)
        mark = "  <- chosen" if plan == chosen else ""
        print(f"cascade 16x2^20 S16 K256 f32 (tile, threads)={plan}: "
              f"{ms:.4f} ms{mark}", flush=True)


if __name__ == "__main__":
    main()
