"""File sources/sinks: raw capture and WAV audio I/O.

Port of ``grtpu.io.file``.  Analogs (SURVEY.md §2.6): gr_file_source /
gr_file_sink(_base), gr_wavfile_source / gr_wavfile_sink (gri_wavfile),
gr_tagged_file_sink.

The file readers and writers are grtpu's host numpy code, so the files are
byte-identical.  A source reads its file once on the host and keeps it on
the executor's device (:func:`grtpu_torch.utils.device.constant`, copied at
the first chunk): each chunk is gathered there, so a run moves the capture
to the card once and a CUDA-graph capture of the step holds no copy.  Sinks
capture on the device and write at ``flush()``.
"""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port, numpy_dtype
from grtpu_torch.utils.device import constant


def load_capture(path: str, dtype=np.complex64, offset_items: int = 0,
                 nitems: Optional[int] = None) -> np.ndarray:
    """Read a raw binary capture (gr_file_source semantics: packed
    native-endian items)."""
    dt = numpy_dtype(dtype)
    count = -1 if nitems is None else nitems
    return np.fromfile(path, dtype=dt, count=count, offset=offset_items * dt.itemsize)


def save_capture(path: str, data, append: bool = False):
    """Write a raw binary capture (gr_file_sink semantics); ``data`` is a
    numpy array or a tensor on any device."""
    mode = "ab" if append else "wb"
    with open(path, mode) as f:
        _host(data).tofile(f)


def _host(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy()
    return np.asarray(data)


def _window(state, n: int, m: int, repeat: bool):
    """Positions ``state + arange(n)`` of a stream of ``m`` items: the
    gather index (wrapped) and, played once, the mask of items inside it."""
    pos = state + torch.arange(n, device=state.device)
    return pos % m, None if repeat else pos < m


class FileSource(Block):
    """gr_file_source: stream a raw capture, optional repeat.  Played once,
    items past the end are zero."""

    def __init__(self, path: str, dtype=torch.complex64, repeat: bool = False,
                 name=None):
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.data = load_capture(path, numpy_dtype(dtype))
        self.repeat = repeat

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)

    def apply(self, state, n: int):
        data = constant(self, "data", state.device)
        idx, inside = _window(state, n, len(self.data), self.repeat)
        y = data[idx]
        if inside is not None:
            y = y * inside.to(y.dtype)
        return state + n, y

    def n_items(self):
        return len(self.data)


class FileSink(Block):
    """gr_file_sink: capture the stream, write on flush()."""

    def __init__(self, path: str, dtype=torch.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.path = path
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def flush(self):
        if self.captured is not None:
            save_capture(self.path, self.captured[0])


class TaggedFileSink(Block):
    """gr_tagged_file_sink: write burst segments delimited by tags to
    numbered files.  Burst extraction happens at flush() from the captured
    stream + the executor's tag store (``executor.sink_tags[name]``)."""

    def __init__(self, basename: str, dtype=torch.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.basename = basename
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def flush(self, tags):
        data = _host(self.captured[0])
        bursts = []
        start = None
        for t in sorted(tags):
            if t.key == "burst" and t.value and start is None:
                start = t.offset
            elif t.key == "burst" and not t.value and start is not None:
                bursts.append((start, t.offset))
                start = None
        for i, (a, b) in enumerate(bursts):
            save_capture(f"{self.basename}.{i:04d}.dat", data[a:b])
        return bursts


# ----------------------------------------------------------------------- wav
def load_wav(path: str):
    """Read a WAV file -> (rate, (nframes, nchan) float32 in [-1, 1])
    (gr_wavfile_source semantics)."""
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return rate, arr.reshape(-1, nch)


def save_wav(path: str, rate: int, data):
    """Write float32 [-1,1] (nframes[, nchan]) to a 16-bit WAV
    (gr_wavfile_sink semantics); ``data`` is a numpy array or a tensor."""
    arr = _host(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    pcm = np.clip(np.round(arr * 32767.0), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(arr.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(pcm.tobytes())


class WavFileSource(Block):
    """gr_wavfile_source: one output port per channel."""

    def __init__(self, path: str, repeat: bool = False, name=None):
        self.rate, data = load_wav(path)
        nch = data.shape[1]
        self.out_ports = tuple(Port(torch.float32) for _ in range(nch))
        super().__init__(name)
        self.data = data
        self.repeat = repeat

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)

    def apply(self, state, n: int):
        data = constant(self, "data", state.device)
        idx, inside = _window(state, n, self.data.shape[0], self.repeat)
        frames = data[idx]
        if inside is not None:
            frames = frames * inside.to(torch.float32)[:, None]
        return state + n, tuple(frames[:, c] for c in range(self.data.shape[1]))


class WavFileSink(Block):
    """gr_wavfile_sink: capture channels, write on flush()."""

    def __init__(self, path: str, rate: int, nchan: int = 1, name=None):
        self.in_ports = tuple(Port(torch.float32) for _ in range(nchan))
        self.out_ports = ()
        super().__init__(name)
        self.path = path
        self.rate = rate
        self.captured = None

    def apply(self, state, *xs):
        return state, ()

    def flush(self):
        if self.captured is not None:
            data = np.stack([_host(c) for c in self.captured], axis=1)
            save_wav(self.path, self.rate, data)
