"""Sources, sinks and constant ops (port of part of ``grtpu.blocks.gengen``).

Analogs: gr_vector_source_X, gr_vector_sink_X, gr_null_sink,
gr_add_const_XX, gr_multiply_const_XX.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port, torch_dtype


def _scalar(k, dtype: torch.dtype):
    """``k`` as the Python scalar of a torch dtype's kind, rounded to that
    dtype (grtpu stores ``np.dtype(dtype).type(k)``)."""
    return torch.tensor(k, dtype=dtype).item()


class AddConst(Block):
    def __init__(self, k, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.k = _scalar(k, self.in_ports[0].dtype)

    def apply(self, state, x):
        return state, x + self.k

    def set_k(self, k):
        self.k = _scalar(k, self.in_ports[0].dtype)
        self.touch()


class MultiplyConst(Block):
    def __init__(self, k, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.k = _scalar(k, self.in_ports[0].dtype)

    def apply(self, state, x):
        return state, x * self.k

    def set_k(self, k):
        self.k = _scalar(k, self.in_ports[0].dtype)
        self.touch()


class VectorSource(Block):
    """Repeat (or play once) a fixed vector (gengen gr_vector_source_X)."""

    def __init__(self, data, repeat: bool = False, dtype=None, vlen: int = 1,
                 name=None):
        arr = torch.as_tensor(np.asarray(data))
        if dtype is not None:
            arr = arr.to(torch_dtype(dtype))
        self.out_ports = (Port(arr.dtype, vlen),)
        super().__init__(name)
        if vlen > 1:
            arr = arr.reshape(-1, vlen)
        self.data = arr
        self.repeat = repeat
        self._data_dev = {}

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)  # read position

    def apply(self, state, n: int):
        data = self._data_dev.get(state.device)
        if data is None:
            data = self._data_dev[state.device] = self.data.to(state.device)
        m = data.shape[0]
        pos = state + torch.arange(n, device=state.device)
        y = data[pos % m]
        if not self.repeat:
            # past-the-end samples are zeroed (finite runs)
            mask = (pos < m).reshape((n,) + (1,) * (y.ndim - 1))
            y = y * mask.to(y.dtype)
        return ((state + n) % m if self.repeat else state + n), y


class VectorSink(Block):
    """Collect everything (gr_vector_sink_X).

    After ``executor.run(...)`` the samples are in ``self.captured[0]`` (a
    tensor on the executor's device); :meth:`data` returns them as numpy.
    """

    def __init__(self, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def data(self):
        return None if self.captured is None else self.captured[0].cpu().numpy()


class NullSink(Block):
    def __init__(self, dtype=torch.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()
