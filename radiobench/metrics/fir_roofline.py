"""fir_roofline: the hand FIR kernels' share of their roofline, in %.

The summed bound of the FIR launches in the traced window (the program's
launch counters, which count each replay of a captured launch) over the
summed profiled device time of the FIR kernels.  A launch's bound is the
larger of its useful operations over the peak its precision can use and
its bytes (each input sample with the history, each tap and each output
once) over the memory rate; its shape comes from the configuration's
``fir_launches``.  Frozen copy of chip_smoke.py's ``bound``.
"""

import re

# one H100 SXM, dense (NVIDIA's data sheet); bf16x3 takes three bf16
# products a tap
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "bf16x3": 989e12}
PRODUCTS = {"f32": 1, "bf16": 1, "bf16x3": 3}
HBM_BYTES_PER_S = 3.35e12
FIR_LAUNCHES = ("fir_tile_fwd", "fir_toeplitz_fwd", "fir_decim_fwd",
                "fir_decim_mma_fwd", "fir_cascade_fwd", "fir_cascade_mma_fwd")
FIR_KERNEL = re.compile(r"\bfir_\w*_kernel\b")


def launch_bound_s(launch: dict, chunk: int) -> float:
    n_in = int(chunk * launch["inputs_per_chunk_sample"])
    n_out = n_in // launch["decimation"]
    k = launch["taps"]
    parts = 2 if launch["complex"] else 1
    flop = 2 * k * n_out * parts
    nbytes = 4 * parts * (n_in + k - 1 + n_out) + 4 * k
    p = launch["precision"]
    return max(flop * PRODUCTS[p] / PEAK_FLOPS[p], nbytes / HBM_BYTES_PER_S)


def read(ctx):
    tr = ctx["trace"]
    shapes = ctx["cfg"].get("fir_launches", [])
    n = sum(ctx["launches"].get(k, 0) for k in FIR_LAUNCHES)
    if tr is None or not shapes or not n:
        return None
    busy = sum(b - a for a, b, name in tr.device if FIR_KERNEL.search(name)) * 1e-9
    if busy <= 0:
        return None
    chunk = ctx["mix"]["chunk"]
    bound = n * sum(launch_bound_s(s, chunk) for s in shapes) / len(shapes)
    return 100.0 * bound / busy
