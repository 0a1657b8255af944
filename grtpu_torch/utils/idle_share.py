"""Device idle share of the port's executor paths, from ``torch.profiler``.

Run on a machine with one NVIDIA GPU, from the repository root:

    python -m grtpu_torch.utils.idle_share

For each path (the tuner -> WBFM graph with its audio FIR on the hand
kernel or on the matmul, the WBFM chain of chip_smoke's main path, the
64-channel ``PfbChannelizer`` graph, the ``PfbArbResampler`` graph, the DMR
variable-rate stream, and one ``channelize`` call per precision) it prints
the wall time of one run, the summed device time of every kernel and copy
the profiler saw, the number of device events, and ``idle = 1 - device /
wall``: how far the host holds the card back.  Each executor path is
profiled twice, with its executor running eagerly and under
``run(device_loop=True)`` (the unprofiled warm run before it captures the
CUDA graphs; the profiled run replays them).  The inputs are random and
made on the card; the shapes are those ``chip_smoke.py`` drives.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from grtpu_torch import Graph, Port, StreamExecutor
from grtpu_torch.blocks.analog import FrequencyModulator, QuadratureDemod
from grtpu_torch.blocks.filter import FirFilter, FreqXlatingFirFilter
from grtpu_torch.blocks.pfb import PfbArbResampler, PfbChannelizer
from grtpu_torch.digital.blocks import ClockRecoveryMMFF, FourLevelSlicer
from grtpu_torch.digital.modems import Fsk4Modem
from grtpu_torch.models.fm import FmDeemph, WfmRcv
from grtpu_torch.ops import pfb
from grtpu_torch.utils import firdes


def _graph(chain, in_dtype=torch.complex64):
    g = Graph()
    g.connect(g.add_input(Port(in_dtype)), *chain,
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


def profile_modes(name: str, build, x, items: int):
    """Profile one executor path eagerly and under device_loop, each in an
    executor of its own made by ``build()``."""
    for mode in ("eager", "device_loop"):
        ex = build()
        profile(f"{name} [{mode}]",
                lambda: ex.run(x, device_loop=mode == "device_loop"), items)


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
        profile_modes(f"tuner -> WfmRcv({impl}), {n} samples, chunk 524288",
                      lambda: StreamExecutor(_graph(
                          [FreqXlatingFirFilter(8, taps, 400e3, fs),
                           WfmRcv(256e3, 8, impl=impl)]), chunk_size=524288),
                      x, n)
    n = 1 << 22
    audio_taps = firdes.low_pass(1.0, 256e3, 15e3, 3.2e3,
                                 firdes.Window.HAMMING)
    tone = torch.sin(torch.arange(n, device="cuda") * 0.0245) * 0.5
    profile_modes(f"WBFM chain (FIR on the kernel), {n} samples, chunk 65536",
                  lambda: StreamExecutor(_graph(
                      [FrequencyModulator(2 * np.pi * 75e3 / 256e3),
                       QuadratureDemod(256e3 / (2 * np.pi * 75e3)),
                       FirFilter(8, audio_taps, "fff", impl="kernel"),
                       FmDeemph(32e3, 75e-6)], torch.float32),
                      chunk_size=65536), tone, n)
    x = noise(n)
    profile_modes(f"PfbChannelizer(64) graph, {n} samples, chunk 262144",
                  lambda: StreamExecutor(_graph([PfbChannelizer(64)]),
                                         chunk_size=1 << 18), x, n)
    profile_modes(f"PfbArbResampler(160/147) graph, {n} samples, chunk "
                  f"301056", lambda: StreamExecutor(
                      _graph([PfbArbResampler(160 / 147)]),
                      chunk_size=147 * 2048), x, n)
    modem = Fsk4Modem(samples_per_symbol=10)
    dibits = np.random.RandomState(4).randint(0, 4, 4800).astype(np.uint8)
    iq = modem.modulate(dibits)
    profile_modes(f"DMR variable-rate stream, {iq.shape[0]} samples, chunk "
                  f"4096", lambda: StreamExecutor(_graph(
                      [QuadratureDemod(1.0 / modem.sensitivity),
                       FirFilter(1, modem.rx_taps / 10, "fff", impl="mxu"),
                       ClockRecoveryMMFF(10, 0.25 * 0.05 ** 2, 0.5, 0.05,
                                         0.005),
                       FourLevelSlicer(3.0)]), chunk_size=4096), iq,
                  iq.shape[0])
    proto = pfb.design_channelizer_taps(64, 12)
    n = 1 << 20
    x = noise(n + len(proto))
    for os_, precision in ((1, "f32"), (1, "bf16x3"), (1, "bf16"), (2, "f32")):
        profile(f"channelize 64 ch os{os_} {precision}, {n} samples",
                lambda: pfb.channelize(x, proto, 64, os_, precision), n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
