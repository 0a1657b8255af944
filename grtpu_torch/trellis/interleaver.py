"""Block interleaver for turbo (PCCC/SCCC) schemes.

grtpu_torch's own copy of ``grtpu.trellis.interleaver`` (numpy only; a test holds the
two to identical output).

Analog of gr-trellis interleaver (gr-trellis/src/lib/interleaver.{h,cc}):
a length-K permutation INTER with its inverse DEINTER, constructible from an
explicit table, from the gr-trellis text file format ('K' then K indices),
or randomly from a seed.  The reference draws random keys with rand() and
quicksort_index; we use numpy's generator argsort — same distribution over
permutations, different draws for a given seed (documented divergence: the
seed is a local reproducibility knob, never an interop surface).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Interleaver:
    def __init__(self, K: int, inter: Sequence[int]):
        self.K = int(K)
        self.INTER = np.asarray(inter, np.int32)
        if self.INTER.shape != (self.K,):
            raise ValueError(f"interleaver table must have K={K} entries")
        if sorted(self.INTER.tolist()) != list(range(self.K)):
            raise ValueError("interleaver table is not a permutation of 0..K-1")
        # DEINTER[INTER[k]] = k  (interleaver.cc constructor invariant)
        self.DEINTER = np.zeros(self.K, np.int32)
        self.DEINTER[self.INTER] = np.arange(self.K, dtype=np.int32)

    @classmethod
    def identity(cls, K: int) -> "Interleaver":
        return cls(K, np.arange(K, dtype=np.int32))

    @classmethod
    def random(cls, K: int, seed: int) -> "Interleaver":
        """interleaver(K, seed): random permutation from a seed."""
        rng = np.random.default_rng(seed)
        return cls(K, np.argsort(rng.random(K)).astype(np.int32))

    @classmethod
    def from_file(cls, path: str) -> "Interleaver":
        """gr-trellis interleaver file: K followed by K indices."""
        tokens = []
        with open(path) as f:
            for line in f:
                line = line.split("#")[0]
                tokens.extend(int(t) for t in line.split())
        K = tokens[0]
        return cls(K, tokens[1:1 + K])

    def write_interleaver_txt(self, path: str):
        with open(path, "w") as f:
            f.write(f"{self.K}\n")
            f.write(" ".join(str(int(i)) for i in self.INTER) + "\n")

    def interleave(self, x: np.ndarray) -> np.ndarray:
        """y[k] = x[INTER[k]] (the gather convention used throughout
        core_algorithms.cc, e.g. sccc_decoder :1003-1009)."""
        return np.asarray(x)[..., self.INTER]

    def deinterleave(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x)[..., self.DEINTER]

    def __repr__(self):
        return f"<Interleaver K={self.K}>"
