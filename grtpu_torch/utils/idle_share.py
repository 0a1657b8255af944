"""Device idle share of the port's executor paths, from ``torch.profiler``.

Run on a machine with one NVIDIA GPU, from the repository root:

    python -m grtpu_torch.utils.idle_share

For each path (the tuner -> WBFM graph with its audio FIR on the hand
kernel, the 64-channel ``PfbChannelizer`` graph, the ``PfbArbResampler``
graph, and one ``channelize`` call per precision) it prints the wall time of
one run, the summed device time of every kernel and copy the profiler saw,
the number of device events, and ``idle = 1 - device / wall``: how far the
host holds the card back.  The inputs are random and made on the card; the
shapes are those ``chip_smoke.py`` drives.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from grtpu_torch import Graph, Port, StreamExecutor
from grtpu_torch.blocks.filter import FreqXlatingFirFilter
from grtpu_torch.blocks.pfb import PfbArbResampler, PfbChannelizer
from grtpu_torch.models.fm import WfmRcv
from grtpu_torch.ops import pfb
from grtpu_torch.utils import firdes


def _graph(chain):
    g = Graph()
    g.connect(g.add_input(Port(torch.complex64)), *chain,
              g.add_output(chain[-1].out_ports[0]))
    return g


def profile(name: str, fn, items: int):
    """Run ``fn`` once warm, then once under the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.device_time for e in events) * 1e-6
    if not events:
        print(f"{name}: the profiler saw no device event", flush=True)
        return
    print(f"{name}: wall {wall * 1e3:.3f} ms, device {device * 1e3:.3f} ms in "
          f"{len(events)} events, idle {1 - device / wall:.3f} "
          f"({items / wall / 1e6:.1f} Msamples/s under the profiler)",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("idle_share: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def noise(n):
        return torch.complex(torch.randn(n, generator=gen, device="cuda"),
                             torch.randn(n, generator=gen, device="cuda"))

    fs, n = 2.048e6, 1 << 23
    taps = firdes.low_pass(1.0, fs, 100e3, 50e3)
    x = noise(n)
    for impl in ("kernel", "mxu"):
        profile(f"tuner -> WfmRcv({impl}), {n} samples, chunk 524288",
                lambda: StreamExecutor(_graph(
                    [FreqXlatingFirFilter(8, taps, 400e3, fs),
                     WfmRcv(256e3, 8, impl=impl)]), chunk_size=524288).run(x),
                n)
    n = 1 << 22
    x = noise(n)
    profile(f"PfbChannelizer(64) graph, {n} samples, chunk 262144",
            lambda: StreamExecutor(_graph([PfbChannelizer(64)]),
                                   chunk_size=1 << 18).run(x), n)
    profile(f"PfbArbResampler(160/147) graph, {n} samples, chunk 301056",
            lambda: StreamExecutor(_graph([PfbArbResampler(160 / 147)]),
                                   chunk_size=147 * 2048).run(x), n)
    proto = pfb.design_channelizer_taps(64, 12)
    n = 1 << 20
    x = noise(n + len(proto))
    for os_, precision in ((1, "f32"), (1, "bf16x3"), (1, "bf16"), (2, "f32")):
        profile(f"channelize 64 ch os{os_} {precision}, {n} samples",
                lambda: pfb.channelize(x, proto, 64, os_, precision), n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
