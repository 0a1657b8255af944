"""The device an entry point of grtpu_torch runs on when none is given."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Nothing is allocated and nothing is probed here: where there is no
    card, the first tensor an entry point makes on the returned device
    raises torch's own error.  Callers that want the CPU say
    ``device="cpu"``."""
    return torch.device(DEFAULT_DEVICE if device is None else device)
