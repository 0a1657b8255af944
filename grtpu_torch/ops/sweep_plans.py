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
* the same bank as a complex64 stream in the kernels' complex modes (ccf:
  the real taps; ccc: the taps turned by a quarter of the band): each
  route's plans as above, and then, beside the real stream, both routes at
  the planner's plan in every precision, the route a call takes marked;
* the WBFM chunk (1 x 65,536, 193 taps, decimate by 8, bf16x3): the
  tensor-core route over outputs a block (``to``), and the FMA route;
* the two decimating routes at 64 x 2^15 outputs, decimations 2 to 16 and 16
  to 256 taps in bf16 and bf16x3, with the route ``cuda_fir._route`` takes,
  for the real stream and for both complex modes (``_dm_min_taps``'
  crossovers);
* the f32 cascade (16 x 2^20, 16 stages of 256 taps): tile and threads;
* a complex stream at decimation 1 (ccf, ccc), 64 x 2^15 outputs at 16 to
  4097 taps and the WBFM bank's 64 x 2^18 at 155, every precision: the
  routes side by side (``fir_decim_mma_fwd`` at decimation 1, the complex
  mode of ``fir_tile_fwd``, ``fir_decim_fwd`` at decimation 1 and the real
  kernel over the stacked planes), the route a call takes marked, and each
  route's plans at the bank's shape and at 1024 and 4097 taps; and the
  bank's real stream at decimation 1, ``fir_toeplitz_fwd`` beside
  ``fir_decim_mma_fwd``.  ``python -m grtpu_torch.ops.sweep_plans
  --decim1`` runs this part alone.

The decimating rows are replayed from a CUDA graph of 20 launches (the
card's time without the host's launch cost), the cascade is timed with CUDA
events over 3 launches.  Needs a CUDA device and nvcc.

    python -m grtpu_torch.ops.sweep_plans --host-cost

prints only what one ``fir_decim`` call at the chunk's shape, and one
``fir_decim_cc`` call at config #1's channel-select chunk (1 x 65,536
complex samples, 99 complex taps, decimate by 8), cost the host (batches of
1,000 calls on the host clock, no synchronize between calls).  It
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
from grtpu_torch.ops.fir import rotate_taps
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


def decim_rows(name, x, taps, d, nout, precision, label, plans, chosen,
               cplx=cf.REAL):
    """One line per plan of a decimating kernel (or of fir_tile_fwd) on (x,
    taps)."""
    b, total = x.shape
    g, k = taps.shape
    for plan in plans + ([] if chosen in plans else [chosen]):
        if name == "fir_tile_fwd":
            launch = cf._tile_launch(b, total, g, k, d, 0, nout, precision,
                                     plan, cplx)
        else:
            launch = cf._decim_launch(name, b, total, g, k, d, 0, nout,
                                      precision, plan, cplx)
        ms = graph_ms(lambda: cf._launch_tile(x, taps, d, 0, nout, precision,
                                              _plan=launch, cplx=cplx))
        mark = "  <- chosen" if plan == chosen else ""
        print(f"{label} {name} {precision} plan={plan}: {ms:.4f} ms{mark}",
              flush=True)


def host_cost(batches: int = 5, calls: int = 1000):
    """Host microseconds of one ``fir_decim`` call at the WBFM chunk (1 x
    65,536, 193 taps, decimate by 8, bf16x3), and of one ``fir_decim_cc``
    call at config #1's channel-select chunk (1 x 65,536 complex samples,
    99 complex taps, decimate by 8, bf16x3), per batch of ``calls``."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    taps = torch.from_numpy(firdes.low_pass(
        1.0, 256e3, 15e3, 3.2e3, firdes.Window.HAMMING).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(1, 65536 + len(taps) - 1)
                         .astype(np.float32)).to(dev)
    tc = torch.from_numpy(rotate_taps(
        firdes.low_pass(1.0, 2.048e6, 100e3, 50e3), 400e3, 2.048e6)).to(dev)
    xc = torch.from_numpy((rng.randn(1, 65536 + len(tc) - 1)
                           + 1j * rng.randn(1, 65536 + len(tc) - 1))
                          .astype(np.complex64)).to(dev)
    for label, call in (
            (f"fir_decim 1x65536 K{len(taps)} d8 bf16x3",
             lambda: cf.fir_decim(x, taps, 8, precision="bf16x3")),
            (f"fir_decim_cc 1x65536 K{len(tc)} d8 bf16x3",
             lambda: cf.fir_decim_cc(xc, tc, 8, precision="bf16x3"))):
        call()
        out = []
        for _ in range(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            out.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        print(f"host cost {label} ({cf.__file__}): median "
              f"{np.median(out):.2f} us per call, batches of {calls}: "
              f"{' '.join(f'{v:.2f}' for v in out)}", flush=True)


def route_times(x, taps, d, nout, precision, cplx, sms) -> str:
    """Both decimating routes at the planner's plans on (x, taps), from a
    CUDA graph, and the route a call takes."""
    b, total = x.shape
    g, k = taps.shape
    out = []
    if precision != "f32":
        launch = cf._decim_launch(
            "fir_decim_mma_fwd", b, total, g, k, d, 0, nout, precision,
            cf._decim_mma_plan(precision, d, k, b, nout, sms, cplx), cplx)
        out.append("tensor_ms=%.4f" % graph_ms(lambda: cf._launch_tile(
            x, taps, d, 0, nout, precision, _plan=launch, cplx=cplx)))
    out.append("fma_ms=%.4f" % graph_ms(lambda: cf._launch_tile(
        x, taps, d, 0, nout, precision, _fma=True, cplx=cplx)))
    route = cf._route(precision, d, k, b, nout, cplx=cplx)
    return " ".join(out) + f" takes {route}"


def decim1_rows(x, taps, precision, cplx, sms, label):
    """The routes of a complex call at decimation 1 on (x, taps), each
    replayed from a CUDA graph: fir_decim_mma_fwd (bf16 modes), the complex
    mode of fir_tile_fwd, fir_decim_fwd at decimation 1 (one phase group)
    and the real FIR over the stacked planes; the route a call takes is
    marked with *."""
    b, total = x.shape
    g, k = taps.shape
    nout = total - (k - 1)
    chosen = cf._route(precision, 1, k, b, nout, cplx=cplx)
    launches = [("tile", cf._tile_launch(
        b, total, g, k, 1, 0, nout, precision,
        cf._tile_plan(precision, 1, k, b, nout, sms, cplx), cplx))]
    if precision != "f32":
        launches.insert(0, ("decim_mma", cf._decim_launch(
            "fir_decim_mma_fwd", b, total, g, k, 1, 0, nout, precision,
            cf._decim_mma_plan(precision, 1, k, b, nout, sms, cplx), cplx)))
    fma = cf._decim_fma_plan(precision, 1, k, b, nout, sms, cplx)
    if fma is not None:
        launches.append(("decim_fma", cf._decim_launch(
            "fir_decim_fwd", b, total, g, k, 1, 0, nout, precision, fma,
            cplx)))
    out = []
    for name, launch in launches:
        ms = graph_ms(lambda: cf._launch_tile(x, taps, 1, 0, nout, precision,
                                              _plan=launch, cplx=cplx))
        out.append(f"{name}={ms:.4f}" + ("*" if name == chosen else ""))
    ms = graph_ms(lambda: cf._decim_complex(x, taps, 1, precision, cplx,
                                            _force_planes=True))
    out.append(f"planes={ms:.4f}" + ("*" if chosen == "planes" else ""))
    print(f"{label} {precision}: {' '.join(out)} ms (takes {chosen})",
          flush=True)


def decim1(dev, sms, rng):
    """A complex stream at decimation 1: the routes side by side at 16 to
    4097 taps (64 x 2^15 outputs) and at the WBFM bank's shape (64 x 2^18,
    155 taps); the bank's real stream on fir_toeplitz_fwd and on
    fir_decim_mma_fwd at decimation 1."""
    n = 1 << 15
    xr = torch.from_numpy(rng.randn(64, n + 4096).astype(np.float32)).to(dev)
    xc = torch.complex(xr, xr.flip(0))
    for k in (16, 32, 64, 155, 256, 512, 1024, 2048, 4097):
        t = np.random.RandomState(k).randn(k) / np.sqrt(k)
        tsets = {cf.CCF: cf._tapsets(t, dev),
                 cf.CCC: torch.from_numpy(rotate_taps(t, 0.25, 1.0))[None]
                 .to(dev)}
        xs = xc[:, :n + k - 1].contiguous()
        for cplx, mode in ((cf.CCF, "ccf"), (cf.CCC, "ccc")):
            for precision in ("f32", "bf16x3", "bf16"):
                decim1_rows(xs, tsets[cplx], precision, cplx, sms,
                            f"decim1 routes 64x2^15 K{k} {mode}")
            if k in (1024, 4097):
                decim_rows("fir_decim_mma_fwd", xs, tsets[cplx], 1, n,
                           "bf16x3", f"decim1 64x2^15 K{k} {mode} "
                           f"(mtb, to, tpb)",
                           [(mtb, 128 * mtb, tpb) for mtb in (4, 2, 1)
                            for tpb in (1, 4, 16)],
                           cf._decim_mma_plan("bf16x3", 1, k, 64, n, sms,
                                              cplx), cplx)
    del xr, xc, xs
    taps155 = firdes.low_pass(1.0, 256e3, 15e3, 4e3)
    k, n = len(taps155), 1 << 18
    x = torch.from_numpy(rng.randn(64, n + k - 1).astype(np.float32)).to(dev)
    xc = torch.complex(x, x.flip(0))
    tsets = {cf.CCF: cf._tapsets(taps155, dev),
             cf.CCC: torch.from_numpy(rotate_taps(taps155, 0.25, 1.0))[None]
             .to(dev)}
    for cplx, mode in ((cf.CCF, "ccf"), (cf.CCC, "ccc")):
        for precision in ("f32", "bf16x3", "bf16"):
            decim1_rows(xc, tsets[cplx], precision, cplx, sms,
                        f"decim1 routes bank 64x2^18 K{k} {mode}")
        # each route's plans at the bank's shape
        for precision in ("bf16x3", "bf16"):
            decim_rows("fir_decim_mma_fwd", xc, tsets[cplx], 1, n, precision,
                       f"decim1 bank {mode} (mtb, to, tpb)",
                       [(mtb, 128 * mtb, tpb) for mtb in (4, 2, 1)
                        for tpb in TPBS],
                       cf._decim_mma_plan(precision, 1, k, 64, n, sms, cplx),
                       cplx)
        decim_rows("fir_decim_fwd", xc, tsets[cplx], 1, n, "f32",
                   f"decim1 bank {mode} (kp, tpb)",
                   [(1, tpb) for tpb in TPBS],
                   cf._decim_fma_plan("f32", 1, k, 64, n, sms, cplx), cplx)
        decim_rows("fir_tile_fwd", xc, tsets[cplx], 1, n, "f32",
                   f"decim1 bank {mode} (threads, kblk)",
                   [(th, k) for th in (256, 128, 64)] + [(256, 80)],
                   cf._tile_plan("f32", 1, k, 64, n, sms, cplx), cplx)
    del xc
    t = tsets[cf.CCF]
    for precision in ("bf16x3", "bf16"):
        tz = graph_ms(lambda: cf._launch_toeplitz(x, t, 0, n, precision))
        launch = cf._decim_launch(
            "fir_decim_mma_fwd", 64, x.shape[1], 1, k, 1, 0, n, precision,
            cf._decim_mma_plan(precision, 1, k, 64, n, sms))
        mma = graph_ms(lambda: cf._launch_tile(x, t, 1, 0, n, precision,
                                               _plan=launch))
        print(f"decim1 real bank 64x2^18 K{k} {precision}: "
              f"fir_toeplitz_fwd={tz:.4f} fir_decim_mma_fwd={mma:.4f} ms "
              f"(takes {cf._route(precision, 1, k, 64, n)})", flush=True)


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if "--host-cost" in sys.argv[1:]:
        return host_cost()
    _build.library()
    sms = cf._sm_count(0)
    rng = np.random.RandomState(0)
    if "--decim1" in sys.argv[1:]:
        return decim1(dev, sms, rng)

    # the WBFM bank
    taps155 = cf._tapsets(firdes.low_pass(1.0, 256e3, 15e3, 4e3), dev)
    k, d, nout = taps155.shape[1], 8, 1 << 15
    x = torch.from_numpy(rng.randn(64, nout * d + k - 1).astype(np.float32)).to(dev)
    for precision in ("bf16x3", "bf16"):
        decim_rows("fir_decim_mma_fwd", x, taps155, d, nout, precision,
                   "bank (mtb, to, tpb)",
                   [(mtb, 128 * mtb, tpb) for mtb in (4, 2, 1)
                    for tpb in TPBS],
                   cf._decim_mma_plan(precision, d, k, 64, nout, sms))
    for precision in ("f32", "bf16x3"):
        decim_rows("fir_decim_fwd", x, taps155, d, nout, precision,
                   "bank (kp, tpb)",
                   [(kp, tpb) for kp in (4, 2, 1) for tpb in TPBS],
                   cf._decim_fma_plan(precision, d, k, 64, nout, sms))

    # the same bank as a complex stream, in both complex modes
    xc = torch.complex(x, x.flip(0))
    tsets = {cf.REAL: taps155, cf.CCF: taps155,
             cf.CCC: torch.from_numpy(rotate_taps(
                 taps155[0].cpu().numpy(), 0.25, 1.0))[None].to(dev)}
    for cplx, mode in ((cf.CCF, "ccf"), (cf.CCC, "ccc")):
        decim_rows("fir_decim_mma_fwd", xc, tsets[cplx], d, nout, "bf16x3",
                   f"bank {mode} (mtb, to, tpb)",
                   [(mtb, 128 * mtb, tpb) for mtb in (4, 2, 1)
                    for tpb in TPBS],
                   cf._decim_mma_plan("bf16x3", d, k, 64, nout, sms, cplx),
                   cplx)
        for precision in ("f32", "bf16x3"):
            decim_rows("fir_decim_fwd", xc, tsets[cplx], d, nout, precision,
                       f"bank {mode} (kp, tpb)",
                       [(kp, tpb) for kp in (4, 2, 1) for tpb in TPBS],
                       cf._decim_fma_plan(precision, d, k, 64, nout, sms,
                                          cplx), cplx)
    # real and complex side by side: both routes at the planner's plans
    for cplx, mode in ((cf.REAL, "real"), (cf.CCF, "ccf"), (cf.CCC, "ccc")):
        xs = x if cplx == cf.REAL else xc
        for precision in ("f32", "bf16x3", "bf16"):
            line = route_times(xs, tsets[cplx], d, nout, precision, cplx, sms)
            print(f"bank routes 64x2^18 K155 d8 {mode} {precision}: {line}",
                  flush=True)
    del x, xc

    # the WBFM chunk
    taps193 = cf._tapsets(firdes.low_pass(1.0, 256e3, 15e3, 3.2e3,
                                          firdes.Window.HAMMING), dev)
    k, nout = taps193.shape[1], 8192
    x = torch.from_numpy(rng.randn(1, nout * d + k - 1).astype(np.float32)).to(dev)
    decim_rows("fir_decim_mma_fwd", x, taps193, d, nout, "bf16x3",
               "chunk (mtb, to, tpb)",
               [(1, 32, 1), (1, 56, 1), (1, 64, 1), (1, 128, 1), (2, 256, 1)],
               cf._decim_mma_plan("bf16x3", d, k, 1, nout, sms))
    decim_rows("fir_decim_fwd", x, taps193, d, nout, "bf16x3",
               "chunk (kp, tpb)", [(4, 1), (2, 1), (1, 1)],
               cf._decim_fma_plan("bf16x3", d, k, 1, nout, sms))
    del x

    # the two decimating routes side by side, 64 x 2^15 outputs, for the
    # real stream and both complex modes
    nout = 1 << 15
    xr = torch.from_numpy(rng.randn(64, nout * 16 + 255)
                          .astype(np.float32)).to(dev)
    for cplx, mode in ((cf.REAL, ""), (cf.CCF, " ccf"), (cf.CCC, " ccc")):
        xm = xr if cplx == cf.REAL else torch.complex(xr, xr.flip(0))
        for d in (2, 3, 4, 8, 16):
            for k in (16, 32, 64, 128, 256):
                tk = cf._tapsets(np.random.RandomState(k).randn(k) / k, dev)
                if cplx == cf.CCC:
                    tk = torch.from_numpy(rotate_taps(
                        tk[0].cpu().numpy(), 0.25, 1.0))[None].to(dev)
                xs = xm[:, :nout * d + k - 1].contiguous()
                for precision in ("bf16", "bf16x3"):
                    line = route_times(xs, tk, d, nout, precision, cplx, sms)
                    print(f"routes 64x2^15 outputs d{d} K{k} {precision}"
                          f"{mode}: {line}", flush=True)
        del xm
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
    del x

    decim1(dev, sms, rng)


if __name__ == "__main__":
    main()
