"""The control's precision: TF32, the format a float32 product takes on
the tensor cores when TF32 is allowed (1 sign, 8 exponent and 10 mantissa
bits), applied here to the operands of every convolution, so that the
control computes in TF32 whichever algorithm the library picks."""

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
