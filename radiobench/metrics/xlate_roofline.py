"""xlate_roofline: the tuner's hand-kernel launches' share of their
roofline, in %.

The launches the program counted under ``fir_decim_cc`` in the traced
window (each replay of a captured launch counted) times one launch's bound,
over the summed profiled time of the complex-taps kernel events: the
decimating kernels' instantiations whose last template argument, the
complex mode, is 2 (``fir_decim_mma_kernel<P, XT, D, 2>`` or
``fir_decim_kernel<...>``).  A launch's bound is the larger of its useful
operations (8 flops a tap and output for complex by complex, three bf16
products a tap at bf16x3) over the peak its precision can use and its
bytes (each input sample with the K - 1 of history, each output and each
complex tap once, 8 bytes each) over the memory rate; its shape is the
configuration's ``xlate_launch``.  None where the count of launches and
the count of kernel events differ, or either is 0.
"""

import re

# one H100 SXM, dense (NVIDIA's data sheet)
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "bf16x3": 989e12}
PRODUCTS = {"f32": 1, "bf16": 1, "bf16x3": 3}
HBM_BYTES_PER_S = 3.35e12
CCC_KERNEL = re.compile(r"\bfir_decim(?:_mma)?_kernel<[^<>]*,\s*2\s*>")


def launch_bound_s(launch: dict, chunk: int) -> float:
    n_in = int(chunk * launch["inputs_per_chunk_sample"])
    n_out = n_in // launch["decimation"]
    k = launch["taps"]
    p = launch["precision"]
    flop = 8 * k * n_out * PRODUCTS[p]
    nbytes = 8 * (n_in + k - 1 + n_out + k)
    return max(flop / PEAK_FLOPS[p], nbytes / HBM_BYTES_PER_S)


def read(ctx):
    tr = ctx["trace"]
    shape = ctx["cfg"].get("xlate_launch")
    n = ctx["launches"].get(shape["kernel"], 0) if shape else 0
    if tr is None or not n:
        return None
    events = [b - a for a, b, name in tr.device if CCC_KERNEL.search(name)]
    if len(events) != n or sum(events) <= 0:
        return None
    return 100.0 * n * launch_bound_s(shape, ctx["mix"]["chunk"]) \
        / (sum(events) * 1e-9)
