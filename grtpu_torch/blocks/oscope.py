"""Triggered scope capture + pubsub bus.

Port of ``grtpu.blocks.oscope``.  Analogs: gr_oscope_sink_x /
gr_oscope_guts (the trigger engine feeding every GUI scope) and gr-wxgui's
pubsub.py key/value bus.

The GUIs themselves are out of scope; the *capture engine* lives on:
OscopeSink collects the stream on the executor's device, and ``frames()``
copies it to the host once and applies the reference's trigger semantics
(level/slope/mode) there to cut display frames.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port


class OscopeSink(Block):
    """gr_oscope_sink_x: capture, then trigger-sliced frames."""

    def __init__(self, frame_size: int = 1024, dtype=torch.float32,
                 name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.frame_size = frame_size
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def frames(self, level: float = 0.0, slope: str = "pos",
               mode: str = "norm", max_frames: int = 16) -> List[np.ndarray]:
        """Cut triggered frames from the capture (gr_oscope_guts semantics:
        trigger on level crossing with given slope; 'auto' mode free-runs
        when no trigger found)."""
        if self.captured is None:
            return []
        x = self.captured[0]
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        n = self.frame_size
        sig = x.real if np.iscomplexobj(x) else x
        if slope == "pos":
            hits = np.nonzero((sig[:-1] < level) & (sig[1:] >= level))[0]
        else:
            hits = np.nonzero((sig[:-1] > level) & (sig[1:] <= level))[0]
        frames = []
        last_end = 0
        for h in hits:
            if h < last_end or h + n > len(x):
                continue
            frames.append(x[h: h + n])
            last_end = h + n
            if len(frames) >= max_frames:
                break
        if not frames and mode == "auto":
            frames = [x[i: i + n] for i in range(0, min(len(x), n * max_frames)
                                                 - n + 1, n)]
        return frames


class Pubsub:
    """gr-wxgui pubsub.py: in-process key/value bus with subscriber
    callbacks (publish on set)."""

    def __init__(self):
        self._vals: Dict[str, object] = {}
        self._subs: Dict[str, List[Callable]] = {}
        self._providers: Dict[str, Callable] = {}

    def subscribe(self, key: str, fn: Callable):
        self._subs.setdefault(key, []).append(fn)

    def unsubscribe(self, key: str, fn: Callable):
        if fn in self._subs.get(key, []):
            self._subs[key].remove(fn)

    def publish(self, key: str, provider: Callable):
        """Register a pull-provider (pubsub.publish)."""
        self._providers[key] = provider

    def __setitem__(self, key: str, value):
        self._vals[key] = value
        for fn in self._subs.get(key, []):
            fn(value)

    def __getitem__(self, key: str):
        if key in self._providers:
            return self._providers[key]()
        return self._vals[key]

    def keys(self):
        return set(self._vals) | set(self._providers)
