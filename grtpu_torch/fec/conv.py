"""Convolutional code (CCSDS k=7, r=1/2) + Viterbi decoder.

Port of ``grtpu.fec.conv``.  Analogs: gnuradio-core/src/lib/viterbi/
viterbi.c (encode + k=7 r=1/2 Viterbi with the CCSDS polynomials) and the
gr_encode/decode_ccsds_27_bb blocks.

The encoder is a vectorized windowed parity; the decoder is grtpu's scan as
a Python step loop of torch ops carrying all 64 path metrics as one vector
(a (64, 2) gather + compare a step, every sum one float32 add in grtpu's
order, so the decisions are grtpu's), then the traceback over the stored
survivor decisions.  No BASELINE path runs it; its hand-kernel route (the
64-state FSM through ``viterbi_fwd``) is listed in ROADMAP.md.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.utils.device import resolve

# CCSDS / NASA-DSN polynomials (octal 171, 133), 7 taps each.
POLYA = 0o171
POLYB = 0o133
K = 7
NSTATES = 64


def _parity_table():
    t = np.zeros(128, np.uint8)
    for v in range(128):
        t[v] = bin(v).count("1") & 1
    return t


_PAR = _parity_table()


def _transition_outputs():
    """out[s, b] = (o0, o1) for transition from state s with input bit b.

    State s = last 6 input bits (newest at LSB)."""
    o0 = np.zeros((NSTATES, 2), np.float32)
    o1 = np.zeros((NSTATES, 2), np.float32)
    for s in range(NSTATES):
        for b in range(2):
            full = ((s << 1) | b) & 0x7F
            o0[s, b] = _PAR[full & POLYA]
            o1[s, b] = _PAR[full & POLYB]
    return o0, o1


_O0, _O1 = _transition_outputs()
_PRED = np.stack([np.arange(NSTATES) >> 1,
                  (np.arange(NSTATES) >> 1) | 32], axis=1)   # pred[s', i]
_POLY_BITS = np.array([[(POLYA >> i) & 1 for i in range(K - 1, -1, -1)],
                       [(POLYB >> i) & 1 for i in range(K - 1, -1, -1)]],
                      np.int32)
_BYTE_WEIGHTS = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.int32)


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device):
    """The code's tables on ``device``, copied once (a captured step copies
    nothing to the card): the expected +-1 outputs of the edge into each
    state from its two predecessors, the predecessors, the generator bits
    and the byte weights."""
    pred = _PRED
    bcur = np.arange(NSTATES) & 1                      # input bit into s'
    e0 = _O0 * 2 - 1
    e1 = _O1 * 2 - 1
    arrays = (e0[pred[:, 0], bcur], e0[pred[:, 1], bcur],
              e1[pred[:, 0], bcur], e1[pred[:, 1], bcur], pred, _POLY_BITS,
              _BYTE_WEIGHTS)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def conv_encode_27(bits, state_bits=0) -> torch.Tensor:
    """Encode bits -> interleaved symbol pairs (2 output bits per input).

    Vectorized: 7-bit sliding windows dotted with the polynomials mod 2.
    ``state_bits``: the 6 bits preceding the block (0 for a flushed start),
    as an int, or a (6,) bit tensor, oldest first (the block's carry)."""
    b = torch.as_tensor(np.asarray(bits) if not isinstance(bits, torch.Tensor)
                        else bits).to(torch.uint8)
    dev = b.device
    n = b.shape[0]
    if isinstance(state_bits, int):
        hist = torch.tensor([(state_bits >> i) & 1 for i in range(5, -1, -1)],
                            dtype=torch.uint8).to(dev)
    else:
        hist = state_bits.to(device=dev, dtype=torch.uint8)
    xb = torch.cat([hist, b])
    idx = (torch.arange(n, device=dev)[:, None]
           + torch.arange(K, device=dev)[None, :])
    win = xb[idx].to(torch.int32)             # (n, 7): bits t-6 .. t
    polys = _tables_on(dev)[5]
    o = (win[:, None, :] * polys[None]).sum(-1) & 1        # (n, 2)
    return o.reshape(-1).to(torch.uint8)


def viterbi_decode_27(symbols) -> torch.Tensor:
    """Soft-decision Viterbi decode.

    symbols: (2*n,) float soft symbols in +-1 (or hard 0/1 scaled), pairs
    (o0, o1) per input bit.  Returns (n,) uint8 decoded bits.
    """
    r = torch.as_tensor(symbols).to(torch.float32).reshape(-1, 2)
    dev = r.device
    n = r.shape[0]
    e00, e01, e10, e11, pred, _, _ = _tables_on(dev)

    # assume a flushed (zero) start state; made on the device (storing a
    # Python scalar would copy from the host, which a capture cannot hold)
    pm = torch.where(torch.arange(NSTATES, device=dev) == 0, 0.0,
                     -1e9).to(torch.float32)
    decisions = torch.empty((n, NSTATES), dtype=torch.bool, device=dev)
    for t in range(n):
        r0, r1 = r[t, 0], r[t, 1]
        # metric of the transition: rt[0]*e0 + rt[1]*e1 (products exact)
        cand0 = pm[pred[:, 0]] + (r0 * e00 + r1 * e10)
        cand1 = pm[pred[:, 1]] + (r0 * e01 + r1 * e11)
        take1 = cand1 > cand0
        pm_new = torch.where(take1, cand1, cand0)
        pm = pm_new - pm_new.max()
        decisions[t] = take1

    # traceback; the state is a 1-element tensor, indexed by index_select
    # (a 0-d index would read the card)
    s = pm.argmax().reshape(1)
    bits = torch.empty(n, dtype=torch.uint8, device=dev)
    for t in range(n - 1, -1, -1):
        bits[t] = (s[0] & 1).to(torch.uint8)
        s = torch.where(decisions[t].index_select(0, s),
                        pred[:, 1].index_select(0, s),
                        pred[:, 0].index_select(0, s))
    return bits


def conv_encode_27_packed(data: bytes, device=None) -> torch.Tensor:
    """Byte helper: encode with 6 zero flush bits appended, on ``device``
    (the card unless named)."""
    bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
    bits = np.concatenate([bits, np.zeros(6, np.uint8)])
    return conv_encode_27(torch.from_numpy(bits).to(resolve(device)))


class EncodeCcsds27(Block):
    """gr_encode_ccsds_27_bb: one packed byte in -> 16 unpacked encoded
    bits out (MSB first), encoder register carried across chunks
    (gr_encode_ccsds_27_bb.cc work)."""

    in_ports = (Port(torch.uint8),)
    out_ports = (Port(torch.uint8),)
    interp = 16

    def init_state(self):
        return torch.zeros((6,), dtype=torch.uint8)   # last 6 bits, oldest first

    def apply(self, state, x):
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
        bits = ((x[:, None] >> shifts[None, :]) & 1).reshape(-1)
        out = conv_encode_27(bits, state_bits=state)
        full = torch.cat([state, bits])
        return full[-6:], out


class DecodeCcsds27(Block):
    """gr_decode_ccsds_27_fb: soft float symbols in (2 per bit, +-1),
    packed bytes out.  As in grtpu, each chunk is decoded as one trellis
    assumed flushed at its edges (the reference decodes continuously with a
    32-bit traceback delay): use chunks much longer than the constraint
    length."""

    in_ports = (Port(torch.float32),)
    out_ports = (Port(torch.uint8),)
    decim = 16

    def apply(self, state, x):
        bits = viterbi_decode_27(x).reshape(-1, 8).to(torch.int32)
        w = _tables_on(x.device)[6]
        packed = (bits * w[None, :]).sum(-1)
        return state, packed.to(torch.uint8)
