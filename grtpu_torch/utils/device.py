"""The device an entry point of grtpu_torch runs on when none is given."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Nothing is allocated and nothing is probed here: where there is no
    card, the first tensor an entry point makes on the returned device
    raises torch's own error.  Callers that want the CPU say
    ``device="cpu"``."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


def constant(owner, name: str, device) -> torch.Tensor:
    """The host numpy constant ``owner.<name>`` as a tensor on ``device``,
    copied once per device and kept on ``owner``: a block's step then moves
    no constant to the card, which a CUDA-graph capture could not hold."""
    cache = owner.__dict__.setdefault("_dev_constants", {})
    key = (name, torch.device(device))
    if key not in cache:
        cache[key] = torch.from_numpy(
            np.ascontiguousarray(getattr(owner, name))).to(device)
    return cache[key]
