"""Counter-based random numbers: sample i of a stream is a function of
(seed, i) alone.

The noise blocks (``blocks.gengen.NoiseSource``, ``models.channel``'s AWGN)
carry only the count of samples drawn.  Drawing at counter i hashes the
64-bit counter with a key made from the seed (two rounds of MurmurHash3's
32-bit finalizer, in int64 arithmetic exact on every device), turns the
hash into a 24-bit uniform in (0, 1) and, for Gaussian samples, pairs two
uniforms by Box-Muller.  So a run resumed from a checkpoint continues the
stream bit for bit, a CUDA-graph replay draws what the eager step draws, and
no ``torch.Generator`` is involved.  The streams differ from grtpu's JAX
key streams; they are held to the same distributions.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32 without leaving int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer, on int64 tensors or Python ints."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def uniform(seed: int, start: torch.Tensor, n: int, lane: int) -> torch.Tensor:
    """float32 uniforms in (0, 1) at counters start .. start+n-1 of one
    lane (an independent stream per lane) of the stream ``seed``.
    ``start`` is a 0-d int64 tensor; the result lies on its device."""
    k1 = _fmix32((int(seed) * 2654435761 + 2 * lane + 1) & _M32)
    k2 = _fmix32(k1 ^ 0x9E3779B9)
    i = start + torch.arange(n, dtype=torch.int64, device=start.device)
    h = _fmix32((i & _M32) ^ k1)
    h = _fmix32(h ^ ((i >> 32) & _M32) ^ k2)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def normal_pair(seed: int, start: torch.Tensor, n: int):
    """Two independent float32 standard normals per counter (Box-Muller on
    lanes 0 and 1)."""
    r = torch.sqrt(-2.0 * torch.log(uniform(seed, start, n, 0)))
    theta = (2.0 * math.pi) * uniform(seed, start, n, 1)
    return r * torch.cos(theta), r * torch.sin(theta)
