"""grtpu_torch — grtpu's software-defined-radio framework on PyTorch and CUDA.

A port of the JAX package ``grtpu`` to PyTorch, aimed at one NVIDIA H100.
``grtpu`` stays the reference: every ported module keeps its counterpart's
module path, class and function names and numerical contract, and a parity
test holds it against ``grtpu`` on the CPU.

What changes in the port:

* Streams are ``torch.Tensor`` s on an explicit ``torch.device``; the
  executor state is a dict of tensors, and each time-block runs eagerly
  (there is no jit).
* The Pallas TPU kernel ``grtpu.ops.pallas_fir._cascade_kernel`` becomes two
  CUDA C++ kernels written for Hopper (``grtpu_torch/csrc/fir_tile.cu``),
  built with ``nvcc`` at first use and reached through
  :mod:`grtpu_torch.ops.cuda_fir`.  On a CPU tensor the same functions run
  their plain PyTorch twins.

This package imports neither ``jax`` nor ``grtpu``.

Layout (the slices ported so far: the frequency-translating WBFM receiver
and the rest of the FM family, the polyphase filterbank, DMR 4FSK):
    grtpu_torch.runtime -- Block protocol, graph builder, time-block executor
                           (fixed rate and the variable-rate FIFO)
    grtpu_torch.ops     -- FIR substrate (decimating, interpolating,
                           filterbank, frequency-translating), FFT filter,
                           rotator/NCO/demod/IIR/control-loop helpers, the
                           polyphase filterbank ops (channelizer,
                           synthesizer, arbitrary resampler), the MMSE
                           interpolator bank, CUDA kernels
    grtpu_torch.blocks  -- analog, convert, filter, gengen, pfb and stream
                           blocks
    grtpu_torch.digital -- constellations, Costas and M&M loops, the 4FSK /
                           GMSK / PSK modems, their graph blocks
    grtpu_torch.models  -- the FM family (WfmRcv, WfmRcvPll, NbfmRx/Tx, WfmTx,
                           AmDemod, FmDemod, pre/de-emphasis) and the DMR
                           burst layer (DmrReceiver, DmrTransmitter)
    grtpu_torch.utils   -- firdes and optfir tap design, the Parks-McClellan
                           engine, engineering notation (numpy)
"""

__version__ = "0.1.0"

from grtpu_torch.runtime.block import Block, Port  # noqa: F401
from grtpu_torch.runtime.graph import Graph, HierBlock  # noqa: F401
from grtpu_torch.runtime.executor import StreamExecutor  # noqa: F401
