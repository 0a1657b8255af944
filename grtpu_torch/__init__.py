"""grtpu_torch — grtpu's software-defined-radio framework on PyTorch and CUDA.

A port of the JAX package ``grtpu`` to PyTorch, aimed at one NVIDIA H100.
``grtpu`` stays the reference: every ported module keeps its counterpart's
module path, class and function names and numerical contract, and a parity
test holds it against ``grtpu`` on the CPU.

What changes in the port:

* Streams are ``torch.Tensor`` s on an explicit ``torch.device``; the
  executor state is a dict of tensors, and each time-block runs eagerly
  (there is no jit).
* The Pallas TPU kernel ``grtpu.ops.pallas_fir._cascade_kernel`` becomes
  hand-written CUDA C++ kernels for Hopper (``grtpu_torch/csrc/fir_tile.cu``:
  ``fir_tile_fwd``, ``fir_cascade_fwd``, ``fir_toeplitz_fwd``,
  ``fir_cascade_mma_fwd``; ``csrc/fir_decim.cu``: ``fir_decim_fwd``,
  ``fir_decim_mma_fwd``), built with ``nvcc`` at first use and reached
  through :mod:`grtpu_torch.ops.cuda_fir`.  Two long ``lax.scan``
  recursions of the trellis slice run as hand kernels too
  (``csrc/trellis_viterbi.cu``, ``csrc/atsc_dfe.cu`` behind
  :mod:`grtpu_torch.ops.cuda_trellis`).  On a CPU tensor the same functions
  run their plain PyTorch twins.
* ``run(device_loop=True)`` and the long per-step loops replay their steps
  from CUDA graphs (:mod:`grtpu_torch.runtime.step_graph`).

This package imports neither ``jax`` nor ``grtpu``.

Layout (the slices ported so far: the FIR substrate and its
kernels; WBFM and the FM family; the polyphase filterbank; DMR 4FSK; the
executor's run modes; the digital modem stack; messages, tags, packets and
OFDM; trellis, FEC and ATSC; the rest of the block library, the vocoders
and the voice, pager and NOAA models; flowgraph files, host I/O, the GUI
sinks and the trace tools):
    grtpu_torch.runtime -- Block protocol and StreamSpec, graph builder,
                           time-block executor (fixed rate, the
                           variable-rate FIFO, stream tags, device_loop),
                           step graphs, PMTs, message queues, TopBlock
    grtpu_torch.ops     -- FIR substrate (decimating, interpolating,
                           filterbank, frequency-translating), FFT filter,
                           rotator/NCO/demod/IIR/control-loop helpers, the
                           polyphase filterbank ops, the MMSE interpolator
                           bank, counter-based noise, the CUDA kernels
    grtpu_torch.blocks  -- analog, convert, filter, gengen, pfb, stream,
                           fftblk, misc, oscope and selftest blocks
    grtpu_torch.digital -- constellations, loops, the modems (4FSK, GMSK,
                           PSK, generic, CPM), LFSR/BERT, equalizers, the
                           packet layer, correlators, OFDM, the tunnel
    grtpu_torch.trellis -- FSMs, interleavers, Viterbi / SISO / turbo
    grtpu_torch.fec     -- Reed-Solomon and the K=7 convolutional code
    grtpu_torch.vocoder -- G.711, G.721 / G.723, CVSD, GSM 06.10, Codec2
    grtpu_torch.models  -- the FM family, DMR, the channel model, ATSC
                           8-VSB, digital voice (GSM over GMSK), the FLEX
                           pager bit layer, NOAA HRPT
    grtpu_torch.grc     -- the flowgraph compiler: JSON / YAML specs and
                           .grc XML to graphs, generated scripts, the
                           command line (python -m grtpu_torch.grc)
    grtpu_torch.io      -- capture and WAV files, UDP / TCP, message
                           bridges, XML-RPC control, the native ring
    grtpu_torch.gui     -- headless spectrum, waterfall, scope,
                           constellation, number and histogram sinks
    grtpu_torch.utils   -- firdes and optfir tap design, the Parks-McClellan
                           engine, engineering notation, the default
                           device, test helpers, the idle-share profiler,
                           tracing and block timing, preferences, the plot
                           and filter-design CLIs, the module scaffold
"""

__version__ = "0.1.0"

from grtpu_torch.runtime.block import Block, Port, StreamSpec  # noqa: F401
from grtpu_torch.runtime.graph import Graph, HierBlock  # noqa: F401
from grtpu_torch.runtime.executor import StreamExecutor  # noqa: F401
from grtpu_torch.runtime.top_block import TopBlock  # noqa: F401
