"""LFSR machinery + scrambler blocks, in PyTorch.

Port of ``grtpu.digital.lfsr``.  Analogs: gri_lfsr.h / gri_glfsr.h
(gnuradio-core/src/lib/general), gr_scrambler_bb / gr_descrambler_bb
(multiplicative, self-synchronizing), gr_additive_scrambler_bb (XOR with a
free-running LFSR, periodic reset), gr_glfsr_source_{b,f}.

Additive scrambling XORs a data-independent sequence, made on the host
once and gathered on the device.  The multiplicative pair is linear over
GF(2): with e the register's bit stream (bit j of the register at step t is
e[t + j]), the descrambler is a GF(2) FIR, out_t = x_t ^ XOR_{j in mask}
e[t + j] with e = (seed bits, inputs), and the scrambler the matching IIR,
n_t = x_t ^ XOR_{j in mask} e[t + j] with e = (seed bits, n).  Both run a
block of bits as one 0/1 float32 matrix product taken mod 2 (the IIR's
impulse response and the register's contribution made on the host), so a
block costs a few device ops instead of one loop step a bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port

_BLOCK = 512       # bits per GF(2) product of the multiplicative scramblers


class GLFSR:
    """Galois LFSR (gri_glfsr): shift right, XOR mask when LSB set."""

    _DEFAULT_MASKS = {
        2: 0x3, 3: 0x5, 4: 0x9, 5: 0x12, 6: 0x21, 7: 0x41, 8: 0x8E,
        9: 0x108, 10: 0x204, 11: 0x402, 12: 0x829, 13: 0x100D, 14: 0x2015,
        15: 0x4001, 16: 0x8016, 17: 0x10004, 18: 0x20013, 19: 0x40013,
        20: 0x80004, 21: 0x100002, 22: 0x200001, 23: 0x400010,
        24: 0x80000D, 25: 0x1000004, 26: 0x2000023, 27: 0x4000013,
        28: 0x8000004, 29: 0x10000002, 30: 0x20000029, 31: 0x40000004,
        32: 0x80000057,
    }

    def __init__(self, mask: int, seed: int = 1):
        self.mask = mask
        self.reg = seed

    @classmethod
    def default_mask(cls, degree: int) -> int:
        return cls._DEFAULT_MASKS[degree]

    def next_bit(self) -> int:
        bit = self.reg & 1
        self.reg >>= 1
        if bit:
            self.reg ^= self.mask
        return bit

    def sequence(self, n: int) -> np.ndarray:
        return np.array([self.next_bit() for _ in range(n)], np.uint8)


class FibonacciLfsr:
    """Fibonacci LFSR, bit-exact to gri_lfsr (gri_lfsr.h:113-118):
    the register is reg_len+1 bits wide; each step outputs the LSB,
    right-shifts, and inserts parity(reg & mask) at bit reg_len."""

    def __init__(self, mask: int, seed: int, reg_len: int):
        self.mask = mask
        self.seed = seed
        self.reg = seed
        self.reg_len = reg_len

    def next_bit(self) -> int:
        out = self.reg & 1
        newbit = bin(self.reg & self.mask).count("1") & 1
        self.reg = (self.reg >> 1) | (newbit << self.reg_len)
        return out

    def reset(self):
        self.reg = self.seed

    def period(self) -> int:
        """Length of the state cycle starting from seed (the free-running
        additive-scrambler sequence period)."""
        save, n = self.reg, 0
        self.reg = self.seed
        while True:
            self.next_bit()
            n += 1
            if self.reg == self.seed or n > (1 << (self.reg_len + 1)):
                break
        self.reg = save
        return n

    def sequence(self, n: int) -> np.ndarray:
        return np.array([self.next_bit() for _ in range(n)], np.uint8)


def _seq_on(block, device) -> torch.Tensor:
    cache = block.__dict__.setdefault("_seq_dev", {})
    if device not in cache:
        cache[device] = torch.from_numpy(block.seq).to(device)
    return cache[device]


class GlfsrSource(Block):
    """gr_glfsr_source_b: PN bit source (+-1 floats with dtype float32)."""

    def __init__(self, degree: int, repeat: bool = True, mask: int = 0,
                 seed: int = 1, dtype=torch.uint8, name=None):
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        g = GLFSR(mask if mask else GLFSR.default_mask(degree), seed)
        self.period = (1 << degree) - 1
        self.seq = g.sequence(self.period)
        self._dtype = self.out_ports[0].dtype

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)

    def apply(self, state, n: int):
        idx = (state + torch.arange(n, device=state.device)) % self.period
        bits = _seq_on(self, state.device)[idx.long()]
        if self._dtype == torch.float32:
            y = bits.to(torch.float32) * 2 - 1
        else:
            y = bits.to(self._dtype)
        return ((state + n) % self.period).to(torch.int32), y


class AdditiveScrambler(Block):
    """gr_additive_scrambler_bb: XOR input bits with an LFSR sequence,
    resetting the register every ``count`` bits (0 = never)."""

    def __init__(self, mask: int, seed: int, length: int, count: int = 0,
                 name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.mask, self.seed, self.length, self.count = mask, seed, length, count
        # the sequence is prefix ++ cycle*: with count > 0 the register
        # resets every count bits (gr_additive_scrambler_bb.cc:55-60);
        # free running, the seed may sit on a tail leading into the cycle
        if count:
            prefix_len, cycle_len = 0, count
        else:
            reg, seen, nbits = seed, {}, 0
            while reg not in seen:
                seen[reg] = nbits
                nbits += 1
                newbit = bin(reg & mask).count("1") & 1
                reg = (reg >> 1) | (newbit << length)
            prefix_len = seen[reg]
            cycle_len = nbits - prefix_len
        self.seq = FibonacciLfsr(mask, seed, length).sequence(
            prefix_len + cycle_len)
        self.prefix_len, self.cycle_len = prefix_len, cycle_len

    def init_state(self):
        return torch.zeros((), dtype=torch.int32)

    def apply(self, state, x):
        t, c = self.prefix_len, self.cycle_len
        pos = state + torch.arange(x.shape[0], device=x.device,
                                   dtype=torch.int32)
        idx = torch.where(pos < t + c, pos, t + (pos - t) % c)
        bits = _seq_on(self, x.device)[idx.long()]
        # fold the carried position (cycle-equivalent) so it never overflows
        end = state + x.shape[0]
        end = torch.where(end < t, end, t + (end - t) % c)
        return end.to(torch.int32), x ^ bits


def _taps(mask: int, length: int):
    return [j for j in range(length + 1) if (mask >> j) & 1]


@functools.lru_cache(maxsize=16)
def _iir_mats(mask: int, length: int, nb: int):
    """(T, G) over GF(2) for nb bits of the scrambler IIR: n = T x + G w
    (mod 2), w the register's bits e[0..L] at the block's start."""
    taps, L = _taps(mask, length), length

    def run(x, w):
        e = list(w)
        for k in range(nb):
            e.append(x[k] ^ (sum(e[k + j] for j in taps) & 1))
        return e[L + 1:]

    zero_w = [0] * (L + 1)
    h = run([1] + [0] * (nb - 1), zero_w)
    T = np.zeros((nb, nb), np.float32)
    for i in range(nb):
        T[i:, i] = h[: nb - i]
    G = np.stack([run([0] * nb, [int(i == j) for i in range(L + 1)])
                  for j in range(L + 1)], axis=1).astype(np.float32)
    return T, G


class _MultiplicativeScrambler(Block):
    def __init__(self, mask: int, seed: int, length: int, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.mask, self.seed, self.length = mask, seed, length
        self._mats = {}

    def init_state(self):
        # the (length+1)-bit register; int64 (torch has no uint32 shifts)
        return torch.tensor(self.seed, dtype=torch.int64)

    def _window(self, reg: torch.Tensor) -> torch.Tensor:
        """The register's bits e[0..L] as 0/1 float32."""
        j = torch.arange(self.length + 1, device=reg.device)
        return ((reg >> j) & 1).to(torch.float32)

    def _register(self, w: torch.Tensor) -> torch.Tensor:
        j = torch.arange(self.length + 1, device=w.device)
        return (w.to(torch.int64) << j).sum()


class Scrambler(_MultiplicativeScrambler):
    """gr_scrambler_bb, bit-exact (gri_lfsr.h:120-125 next_bit_scramble):
    out = reg & 1;  reg <- (reg >> 1) | ((parity(reg & mask) ^ in) << L).
    Run a block at a time as the GF(2) IIR it is (see the module doc)."""

    def _on(self, nb, device):
        key = (nb, device)
        if key not in self._mats:
            self._mats[key] = tuple(
                torch.from_numpy(m).to(device)
                for m in _iir_mats(self.mask, self.length, nb))
        return self._mats[key]

    def apply(self, state, x):
        w = self._window(state)
        xf = (x & 1).to(torch.float32)
        outs = []
        for i0 in range(0, x.shape[0], _BLOCK):
            xb = xf[i0:i0 + _BLOCK]
            T, G = self._on(xb.shape[0], x.device)
            e = torch.cat([w, torch.remainder(T @ xb + G @ w, 2.0)])
            outs.append(e[: xb.shape[0]])
            w = e[xb.shape[0]: xb.shape[0] + self.length + 1]
        y = torch.cat(outs) if outs else xf
        return self._register(w), y.to(torch.uint8)


class Descrambler(_MultiplicativeScrambler):
    """gr_descrambler_bb, bit-exact (gri_lfsr.h:127-132
    next_bit_descramble): out = parity(reg & mask) ^ in;
    reg <- (reg >> 1) | (in << L).  Self-synchronizing: a GF(2) FIR."""

    def apply(self, state, x):
        n, L = x.shape[0], self.length
        e = torch.cat([self._window(state).to(torch.uint8), x & 1])
        y = x & 1
        for j in _taps(self.mask, L):
            y = y ^ e[j: j + n]
        return self._register(e[n: n + L + 1]), y
