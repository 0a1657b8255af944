"""Finite state machine for trellis coding.

grtpu_torch's own copy of ``grtpu.trellis.fsm`` (numpy only; a test holds the
two to identical output).

Analog of gr-trellis fsm class (gr-trellis/src/lib/fsm.{h,cc}): an FSM is
(I, S, O, NS, OS) — input alphabet size, state count, output alphabet size,
next-state table NS[s*I + i], output table OS[s*I + i].  Construction from
explicit tables, from a rate-k/n convolutional generator matrix (octal
generators), or from the gr-trellis file format.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def dec2base(num: int, base: int, ndigits: int) -> list:
    """fsm_utils.dec2base: `num` as `ndigits` base-`base` digits, MSD first."""
    s = [0] * ndigits
    n = num
    for i in range(ndigits):
        s[ndigits - 1 - i] = n % base
        n //= base
    if n:
        raise ValueError(f"{num} needs more than {ndigits} base-{base} digits")
    return s


def base2dec(digits, base: int) -> int:
    """fsm_utils.base2dec: base-`base` digit list (MSD first) -> int."""
    n = 0
    for d in digits:
        n = n * base + int(d)
    return n


class FSM:
    def __init__(self, I: int, S: int, O: int,
                 NS: Sequence[int], OS: Sequence[int]):
        self.I, self.S, self.O = I, S, O
        self.NS = np.asarray(NS, np.int32).reshape(S, I)
        self.OS = np.asarray(OS, np.int32).reshape(S, I)
        self._build_predecessors()
        self._TMi = self._TMl = None  # termination tables, built lazily

    @classmethod
    def from_file(cls, path: str) -> "FSM":
        """gr-trellis file format: 'I S O' then NS table then OS table.

        Like fsm.cc's reader, anything after the required 3 + 2*S*I
        integers is ignored (the shipped fsm_files carry free-text
        generator-polynomial notes after the tables)."""
        tokens = []
        need = None
        with open(path) as f:
            for line in f:
                line = line.split("#")[0]
                for t in line.split():
                    try:
                        tokens.append(int(t))
                    except ValueError:
                        break  # trailing commentary: stop parsing this line
                if need is None and len(tokens) >= 3:
                    need = 3 + 2 * tokens[1] * tokens[0]
                if need is not None and len(tokens) >= need:
                    break
        I, S, O = tokens[0], tokens[1], tokens[2]
        body = tokens[3:]
        NS = body[: S * I]
        OS = body[S * I: 2 * S * I]
        return cls(I, S, O, NS, OS)

    @classmethod
    def from_convolutional(cls, k: int, n: int, generators) -> "FSM":
        """Rate k/n feedforward convolutional code from generator
        polynomials G[k][n] given as plain integer bit masks (use 0o...
        literals for the conventional octal notation) — fsm.cc's (k,n,G)
        constructor.  State = shift register contents per input line."""
        G = np.asarray([[int(g) for g in row] for row in
                        np.atleast_2d(generators)])
        assert G.shape == (k, n)
        # memory per input line
        mem = [max(int(g).bit_length() - 1, 0) for g in
               [int(np.max(G[i])) for i in range(k)]]
        S = 1 << sum(mem)
        I = 1 << k
        O = 1 << n
        NS = np.zeros((S, I), np.int32)
        OS = np.zeros((S, I), np.int32)
        for s in range(S):
            # unpack per-line registers
            regs = []
            acc = s
            for m in reversed(mem):
                regs.append(acc & ((1 << m) - 1))
                acc >>= m
            regs = regs[::-1]
            for inp in range(I):
                ibits = [(inp >> (k - 1 - j)) & 1 for j in range(k)]
                full = [(ibits[j] << mem[j]) | regs[j] for j in range(k)]
                out = 0
                for oi in range(n):
                    b = 0
                    for j in range(k):
                        b ^= bin(full[j] & int(G[j, oi])).count("1") & 1
                    out = (out << 1) | b
                ns = 0
                for j in range(k):
                    nr = full[j] >> 1 if mem[j] > 0 else 0
                    # new register drops oldest bit: (ibit<<(mem-1)) | reg>>1
                    nr = ((ibits[j] << max(mem[j] - 1, 0)) | (regs[j] >> 1)) \
                        & ((1 << mem[j]) - 1) if mem[j] > 0 else 0
                    ns = (ns << mem[j]) | nr
                NS[s, inp] = ns
                OS[s, inp] = out
        return cls(I, S, O, NS.reshape(-1), OS.reshape(-1))

    @classmethod
    def from_isi(cls, mod_size: int, ch_length: int) -> "FSM":
        """ISI-channel trellis (fsm.cc:234-253): input alphabet I=mod_size,
        state = the last ch_length-1 inputs (base-I digits, most recent
        first), output = full base-I word of the last ch_length inputs —
        an index into a make_isi_lookup table."""
        I = int(mod_size)
        S = I ** (int(ch_length) - 1)
        NS = np.zeros((S, I), np.int32)
        OS = np.zeros((S, I), np.int32)
        for s in range(S):
            for i in range(I):
                t = i * S + s
                NS[s, i] = t // I
                OS[s, i] = t
        return cls(I, S, S * I, NS.reshape(-1), OS.reshape(-1))

    @classmethod
    def from_cpm(cls, P: int, M: int, L: int) -> "FSM":
        """CPM trellis per Rimoldi's decomposition (fsm.cc:267-296): h=K/P
        (K,P coprime), alphabet M, frequency-pulse length L symbols.
        Output symbol indexes a make_cpm_signals basis-coefficient table."""
        I = int(M)
        S = (M ** (L - 1)) * P
        NS = np.zeros((S, I), np.int32)
        OS = np.zeros((S, I), np.int32)
        for s in range(S):
            for i in range(I):
                s1, v = divmod(s, P)
                ns1 = (i * (M ** (L - 1)) + s1) // M
                nv = (i + v) % P if L == 1 else (s1 % M + v) % P
                NS[s, i] = ns1 * P + nv
                OS[s, i] = i * S + s
        return cls(I, S, (M ** L) * P, NS.reshape(-1), OS.reshape(-1))

    @classmethod
    def from_product(cls, fsm1: "FSM", fsm2: "FSM") -> "FSM":
        """Joint trellis of two FSMs running side by side (fsm.cc:307-331):
        state/input/output are the pairs, packed fsm1-major."""
        I = fsm1.I * fsm2.I
        S = fsm1.S * fsm2.S
        O = fsm1.O * fsm2.O
        s1, s2 = np.divmod(np.arange(S), fsm2.S)
        i1, i2 = np.divmod(np.arange(I), fsm2.I)
        NS = (fsm1.NS[np.ix_(s1, i1)] * fsm2.S + fsm2.NS[np.ix_(s2, i2)])
        OS = (fsm1.OS[np.ix_(s1, i1)] * fsm2.O + fsm2.OS[np.ix_(s2, i2)])
        return cls(I, S, O, NS.reshape(-1), OS.reshape(-1))

    def radix(self, n: int) -> "FSM":
        """Radix-n FSM: one step = n steps of self (fsm.cc:338-367).
        Inputs/outputs are base-I/base-O words, most significant first."""
        I = self.I ** n
        O = self.O ** n
        NS = np.zeros((self.S, I), np.int32)
        OS = np.zeros((self.S, I), np.int32)
        for s in range(self.S):
            for i in range(I):
                ii = dec2base(i, self.I, n)
                ns, o = s, 0
                for k in range(n):
                    o = o * self.O + self.OS[ns, ii[k]]
                    ns = self.NS[ns, ii[k]]
                NS[s, i] = ns
                OS[s, i] = o
        return FSM(I, self.S, O, NS.reshape(-1), OS.reshape(-1))

    def _generate_TM(self):
        """Termination tables (fsm.cc generate_TM/find_es :401-456):
        TMl[s, es] = fewest steps from state s to state es (S = unreachable),
        TMi[s, es] = first input on that shortest path (-1 if none)."""
        S, I = self.S, self.I
        TMl = np.full((S, S), S, np.int32)
        TMi = np.full((S, S), -1, np.int32)
        np.fill_diagonal(TMl, 0)
        for _ in range(max(S - 1, 1)):
            # relax: TMl[s,es] = min_i 1 + TMl[NS[s,i], es]
            cand = 1 + TMl[self.NS, :]          # (S, I, S)
            best_i = cand.argmin(axis=1)        # (S, S)
            best_l = np.take_along_axis(cand, best_i[:, None, :], 1)[:, 0, :]
            upd = best_l < TMl
            TMl = np.where(upd, best_l, TMl)
            TMi = np.where(upd, best_i.astype(np.int32), TMi)
        self._TMl, self._TMi = TMl, TMi

    @property
    def TMl(self) -> np.ndarray:
        if self._TMl is None:
            self._generate_TM()
        return self._TMl

    @property
    def TMi(self) -> np.ndarray:
        if self._TMi is None:
            self._generate_TM()
        return self._TMi

    def termination_inputs(self, state: int, end_state: int) -> list:
        """Input sequence driving the FSM from `state` to `end_state` along
        the TMi shortest path (the tail-biting/termination idiom the
        reference's TM tables exist for)."""
        if self.TMl[state, end_state] >= self.S and state != end_state:
            raise ValueError("end state unreachable")
        seq, s = [], state
        while s != end_state:
            i = int(self.TMi[s, end_state])
            seq.append(i)
            s = int(self.NS[s, i])
        return seq

    def write_fsm_txt(self, path: str):
        """Write the gr-trellis file format (fsm.cc write_fsm_txt:528-546)."""
        with open(path, "w") as f:
            f.write(f"{self.I} {self.S} {self.O}\n\n")
            for row in self.NS:
                f.write(" ".join(str(v) for v in row) + "\n")
            f.write("\n")
            for row in self.OS:
                f.write(" ".join(str(v) for v in row) + "\n")
            f.write("\n")

    def _build_predecessors(self):
        """PS[s] = list of (prev_state, input) reaching s."""
        preds = [[] for _ in range(self.S)]
        for s in range(self.S):
            for i in range(self.I):
                preds[self.NS[s, i]].append((s, i))
        # uniform in-degree for vectorized Viterbi (true for shift-register
        # FSMs); ragged FSMs fall back to padding with -1
        deg = max(len(p) for p in preds)
        PS = np.full((self.S, deg), -1, np.int32)
        PI = np.full((self.S, deg), -1, np.int32)
        for s, plist in enumerate(preds):
            for j, (ps, pi) in enumerate(plist):
                PS[s, j] = ps
                PI[s, j] = pi
        self.PS, self.PI = PS, PI

    def encode(self, inputs: np.ndarray, start_state: int = 0) -> np.ndarray:
        """Run the FSM (trellis_encoder_XX semantics)."""
        s = start_state
        out = np.zeros(len(inputs), np.int32)
        for t, i in enumerate(np.asarray(inputs, np.int32)):
            out[t] = self.OS[s, i]
            s = self.NS[s, i]
        return out
