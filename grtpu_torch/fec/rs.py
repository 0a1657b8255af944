"""Reed-Solomon codec over GF(2^8).

grtpu_torch's own copy of ``grtpu.fec.rs`` (numpy only; a test holds the
two to identical output).

Analog of the Karn librs in gnuradio-core/src/lib/reed-solomon
({encode,decode,init}_rs.c): char-parameterized RS plus the CCSDS (255,223)
configuration (the same family gr-atsc uses for RS(207,187) via padding).

Implementation: GF(256) log/antilog tables built from the field polynomial;
encoding is polynomial long division (systematic); decoding is syndromes ->
Berlekamp-Massey -> Chien search -> Forney.  Syndrome evaluation (the
streaming hot path) is vectorized; the rare-path error solve is plain
numpy/int control-plane code.
"""

from __future__ import annotations

import numpy as np


class ReedSolomon:
    """RS over GF(2^8), natural length 255, shortened via ``pad``.

    Parameters mirror init_rs_char: field polynomial, first consecutive
    root (fcr), primitive element power (prim), number of parity roots.
    Codeword = data (k = 255 - nroots - pad symbols) + parity (nroots).
    """

    def __init__(self, gfpoly: int = 0x187, fcr: int = 112, prim: int = 11,
                 nroots: int = 32, pad: int = 0):
        self.nn = 255
        self.nroots = nroots
        self.pad = pad
        self.fcr = fcr
        self.prim = prim
        self.k = 255 - nroots - pad
        self._build_field(gfpoly)
        self._build_genpoly()

    # ---------------------------------------------------------------- field
    def _build_field(self, gfpoly):
        alpha_to = np.zeros(256, np.int32)
        index_of = np.zeros(256, np.int32)
        mask = 1
        for i in range(255):
            index_of[mask] = i
            alpha_to[i] = mask
            mask <<= 1
            if mask & 256:
                mask ^= gfpoly
            mask &= 255
        alpha_to[255] = 0
        index_of[0] = 255
        self.alpha_to = alpha_to
        self.index_of = index_of
        self.iprim = next(i for i in range(1, 256)
                          if (i * self.prim) % 255 == 1)

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.alpha_to[(self.index_of[a] + self.index_of[b]) % 255])

    def inv(self, a: int) -> int:
        return int(self.alpha_to[(255 - self.index_of[a]) % 255])

    def _polymul(self, p, q):
        out = [0] * (len(p) + len(q) - 1)
        for i, pi in enumerate(p):
            for j, qj in enumerate(q):
                out[i + j] ^= self.mul(pi, qj)
        return out

    def _build_genpoly(self):
        """g(x) = prod_{j} (x - alpha^{(fcr+j)*prim}), highest-degree-first,
        monic."""
        g = [1]
        for j in range(self.nroots):
            root = int(self.alpha_to[((self.fcr + j) * self.prim) % 255])
            g = self._polymul(g, [1, root])
        self.genpoly = np.array(g, np.int32)  # len nroots+1, g[0] = 1

    # --------------------------------------------------------------- encode
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: (k,) symbols -> (nroots,) parity (systematic)."""
        data = np.asarray(data, np.int32)
        assert len(data) == self.k, (len(data), self.k)
        rem = np.concatenate([data, np.zeros(self.nroots, np.int32)])
        g = self.genpoly
        gl = self.index_of[g]  # logs; g[0]=1 -> log 0
        gnz = g != 0
        for i in range(self.k):
            coef = rem[i]
            if coef:
                lc = self.index_of[coef]
                contrib = np.where(
                    gnz, self.alpha_to[(gl + lc) % 255], 0)
                rem[i:i + self.nroots + 1] ^= contrib
        return rem[self.k:].astype(np.uint8)

    def encode_codeword(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.uint8)
        return np.concatenate([data, self.encode(data)])

    # --------------------------------------------------------------- decode
    def syndromes(self, codeword: np.ndarray) -> np.ndarray:
        """S_j = C(alpha^{(fcr+j)*prim}); vectorized over symbols."""
        c = np.asarray(codeword, np.int32)
        n = len(c)
        degs = np.arange(n - 1, -1, -1, dtype=np.int64)  # c[0] highest power
        logs = self.index_of[c]
        nz = c != 0
        syn = np.zeros(self.nroots, np.int32)
        for j in range(self.nroots):
            root = ((self.fcr + j) * self.prim) % 255
            vals = np.where(nz, self.alpha_to[(logs + degs * root) % 255], 0)
            syn[j] = np.bitwise_xor.reduce(vals)
        return syn

    def check(self, codeword: np.ndarray) -> bool:
        return not self.syndromes(codeword).any()

    def syndromes_batch(self, codewords: np.ndarray) -> np.ndarray:
        """(B, n) codewords -> (B, nroots) syndromes in one vectorized
        pass (the per-segment python loop was the ATSC transport
        bottleneck — 312 RS segments per field)."""
        c = np.asarray(codewords, np.int32)
        B, n = c.shape
        degs = np.arange(n - 1, -1, -1, dtype=np.int64)
        logs = self.index_of[c]                          # (B, n)
        nz = c != 0
        roots = (np.arange(self.nroots, dtype=np.int64)
                 + self.fcr) * self.prim % 255           # (nroots,)
        # (B, nroots, n) exponents; xor-reduce over symbols
        expo = (logs[:, None, :] + degs[None, None, :]
                * roots[None, :, None]) % 255
        vals = np.where(nz[:, None, :], self.alpha_to[expo], 0)
        return np.bitwise_xor.reduce(vals, axis=2)       # (B, nroots)

    def decode_batch(self, codewords: np.ndarray):
        """Decode (B, n) codewords: vectorized syndrome screen, BM only
        on the segments that actually have errors.  Returns
        (corrected (B, n) uint8, nerr (B,) with -1 for uncorrectable)."""
        c = np.asarray(codewords, np.int32)
        syn = self.syndromes_batch(c)
        bad = syn.any(axis=1)
        out = c.astype(np.uint8).copy()
        nerr = np.zeros(len(c), np.int32)
        for i in np.flatnonzero(bad):
            fixed, ne = self.decode(c[i])
            nerr[i] = ne
            if ne >= 0:
                out[i] = fixed
        return out, nerr

    def decode(self, codeword: np.ndarray):
        """Correct up to nroots//2 symbol errors in place.

        Returns (corrected codeword, n_errors) or (input, -1) on failure."""
        cw = np.asarray(codeword, np.int32).copy()
        S = self.syndromes(cw)
        if not S.any():
            return cw.astype(np.uint8), 0
        # Berlekamp-Massey for the error locator Lambda(x) (lowest-first)
        Lam = [1] + [0] * self.nroots
        B = [1] + [0] * self.nroots
        L = 0
        m = 1
        b = 1
        for n_i in range(self.nroots):
            d = S[n_i]
            for i in range(1, L + 1):
                d ^= self.mul(Lam[i], int(S[n_i - i]))
            if d == 0:
                m += 1
            elif 2 * L <= n_i:
                T = Lam[:]
                coef = self.mul(d, self.inv(b))
                for i in range(self.nroots + 1 - m):
                    Lam[i + m] ^= self.mul(coef, B[i])
                L = n_i + 1 - L
                B = T
                b = d
                m = 1
            else:
                coef = self.mul(d, self.inv(b))
                for i in range(self.nroots + 1 - m):
                    Lam[i + m] ^= self.mul(coef, B[i])
                m += 1
        deg = max(i for i, v in enumerate(Lam) if v) if any(Lam) else 0
        if deg != L or L == 0:
            return codeword, -1
        # Chien search over valid positions
        n = len(cw)
        err_pos = []
        for pos in range(n):
            # position pos corresponds to power p = n-1-pos of alpha^prim...
            # locator roots: Lambda(alpha^{-prim * p}) == 0
            p = n - 1 - pos
            xinv = self.alpha_to[(-self.prim * p) % 255]
            v = 0
            xp = 1
            for li in Lam[:L + 1]:
                v ^= self.mul(li, xp)
                xp = self.mul(xp, int(xinv))
            if v == 0:
                err_pos.append(pos)
        if len(err_pos) != L:
            return codeword, -1
        # Forney: Omega(x) = [S(x) Lambda(x)] mod x^nroots
        Sx = [int(s) for s in S]
        Om = [0] * self.nroots
        for i in range(self.nroots):
            acc = 0
            for j in range(min(i + 1, L + 1)):
                acc ^= self.mul(Lam[j], Sx[i - j])
            Om[i] = acc
        for pos in err_pos:
            p = n - 1 - pos
            xinv = int(self.alpha_to[(-self.prim * p) % 255])
            # Omega(xinv)
            num = 0
            xp = 1
            for oi in Om:
                num ^= self.mul(oi, xp)
                xp = self.mul(xp, xinv)
            # Lambda'(xinv): odd-power terms
            den = 0
            xp = 1
            xinv2 = self.mul(xinv, xinv)
            for i in range(1, L + 1, 2):
                den ^= self.mul(Lam[i], xp)
                xp = self.mul(xp, xinv2)
            if den == 0:
                return codeword, -1
            mag = self.mul(num, self.inv(den))
            # scale by x^{1-fcr} evaluated at root (fcr correction)
            corr = self.mul(
                mag, int(self.alpha_to[(self.prim * p * (1 - self.fcr)) % 255]))
            cw[pos] ^= corr
        if self.syndromes(cw).any():
            return codeword, -1
        return cw.astype(np.uint8), L


def rs_ccsds() -> ReedSolomon:
    """CCSDS RS(255,223): poly 0x187, fcr 112, prim 11, 32 roots."""
    return ReedSolomon(0x187, 112, 11, 32)


def rs_simple(nroots: int = 16, pad: int = 0) -> ReedSolomon:
    """Plain RS with poly 0x11d, fcr 0, prim 1 (the common shortened
    configuration, e.g. ATSC RS(207,187) with nroots=20, pad=48)."""
    return ReedSolomon(0x11D, 0, 1, nroots, pad)


def rs_atsc() -> ReedSolomon:
    """ATSC RS(207,187): t=10 over GF(256), poly 0x11d, fcr 0."""
    return ReedSolomon(0x11D, 0, 1, 20, 48)
