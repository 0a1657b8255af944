"""Codec2 v0.1 (2500 bit/s) voice codec: 160 samples <-> 50 bits.

Port of ``grtpu.vocoder.codec2``: the same host NumPy codec (this file keeps
its own copy, and its own byte-identical copy of ``data_codec2.npz``); only
the two blocks differ, see :class:`Codec2Encode`.

Reference behavior: gr-vocoder/lib/codec2/ (David Rowe's codec2, the early
version vendored by GNU Radio 3.5) wrapped by vocoder_codec2_encode_sp /
_decode_ps.  A sinusoidal ("harmonic") codec:

  analysis (per 10 ms subframe, codec2.c analyse_one_frame):
    NLP pitch estimation (square -> DC notch -> 48-tap LPF -> decimate x5 ->
    512-pt power spectrum peak + sub-multiple search, nlp.c) -> two-stage
    harmonic-sum pitch refinement -> per-harmonic amplitude estimation from
    the 512-pt windowed DFT -> MBE voicing decision (sine.c).
  encode (20 ms = 2 subframes, 50 bits): Wo (7) + 10 scalar-quantised LSPs
    (36) + LPC energy (5) + 2 voicing bits, Gray-coded and MSB-packed
    (quantise.c, pack.c).
  decode: LSP -> LPC -> per-harmonic amplitudes from the LPC spectrum
    (aks_to_M2), zero-order phase synthesis with a glottal-pulse phase table
    (phase.c), background-noise postfilter, and 512-pt inverse-FFT sinusoidal
    synthesis with trapezoidal overlap-add (sine.c synthesise); the first
    10 ms subframe uses LSP/energy interpolation between frames (interp.c).

This is a faithful float re-implementation in vectorized NumPy (frame-level
host codec, like the reference's scalar C).  The quantiser codebooks,
glottal phase table, and NLP decimation filter are data tables extracted
from the reference build (data_codec2.npz); everything else is re-derived.
Exactness: the encoder mirrors the reference's float32 arithmetic where it
gates quantiser decisions (pitch-refinement grid accumulation, double->
float promotions) and is 100% byte-identical to the compiled reference on
the test corpus.  The decoder reproduces the reference's libc rand()
stream (glibc TYPE_3 generator, seed 1 — phase jitter, unvoiced phases,
postfilter randomization, drawn in the C's exact per-harmonic order) and
its float32 phase/bin arithmetic, matching the reference's output samples
to float tolerance (>=50 dB; residual = kiss_fft f32 vs numpy f64
rounding).  tests/test_vocoder_codec2.py asserts both.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

import torch

from grtpu_torch.runtime.block import Block, Port, port_s

_D = np.load(os.path.join(os.path.dirname(__file__), "data_codec2.npz"))
GLOTTAL = _D["glottal"].astype(np.float64)
NLP_FIR = _D["nlp_fir"].astype(np.float64)
LSP_CB = [_D[f"lsp_cb{i+1}"].astype(np.float64) for i in range(10)]
LSP_BITS = [4, 4, 4, 4, 4, 4, 4, 3, 3, 2]

N = 80                  # samples per subframe (10 ms)
M = 320                 # pitch analysis window
NW = 279                # analysis window length
FFT_ENC = 512
FFT_DEC = 512
TW = 40                 # synthesis window trapezoid overlap
P_MIN, P_MAX = 20, 160
LPC_ORD = 10
WO_BITS, WO_LEVELS = 7, 128
E_BITS, E_LEVELS = 5, 32
E_MIN_DB, E_MAX_DB = -10.0, 40.0
V_THRESH = 6.0
PI, TWO_PI = np.pi, 2 * np.pi
FS = 8000
BITS_PER_FRAME = 50
SAMPLES_PER_FRAME = 160

# NLP constants (nlp.c:43-52)
PE_FFT_SIZE, DEC, COEFF, CNLP, NLP_NTAP = 512, 5, 0.95, 0.3, 48

# --- analysis/synthesis windows (sine.c make_analysis/synthesis_window) ----
def _make_windows():
    w = np.zeros(M)
    # the C loop runs i in [M/2-NW/2, M/2+NW/2) = NW-1 points, denom NW-1
    w[M // 2 - NW // 2: M // 2 + NW // 2] = \
        0.5 - 0.5 * np.cos(TWO_PI * np.arange(NW - 1) / (NW - 1))
    m = 1.0 / np.sqrt(np.sum(w * w) * FFT_ENC)
    w = w * m
    # DFT of the zero-phase-shifted window, swapped to be symmetric about
    # FFT_ENC/2 (the freq-domain window used in voicing estimation)
    Wt = np.zeros(FFT_ENC)
    Wt[: NW // 2] = w[M // 2: M // 2 + NW // 2]
    Wt[FFT_ENC - NW // 2:] = w[M // 2 - NW // 2: M // 2]
    W = np.fft.fftshift(np.fft.fft(Wt))
    Pn = np.zeros(2 * N)
    win = np.arange(2 * TW) / (2 * TW)
    Pn[N // 2 - TW: N // 2 + TW] = win
    Pn[N // 2 + TW: 3 * N // 2 - TW] = 1.0
    Pn[3 * N // 2 - TW: 3 * N // 2 + TW] = 1.0 - win
    return w, W, Pn


_w, _W, _Pn = _make_windows()


class Model(NamedTuple):
    Wo: float
    L: int
    A: np.ndarray        # (L+1,), A[0] unused
    phi: np.ndarray
    voiced: int


# --- NLP pitch estimator (nlp.c) -------------------------------------------
class Nlp:
    def __init__(self):
        self.sq = np.zeros(M)
        self.mem_x = 0.0
        self.mem_y = 0.0
        self.mem_fir = np.zeros(NLP_NTAP)

    def __call__(self, Sn, prev_Wo):
        n, m = N, M
        sq = self.sq
        sq[m - n:] = Sn[m - n:] ** 2
        # DC notch (sequential 1-pole; 80 samples)
        for i in range(m - n, m):
            notch = sq[i] - self.mem_x + COEFF * self.mem_y
            self.mem_x = sq[i]
            self.mem_y = notch
            sq[i] = notch
        # 48-tap FIR over the new samples with a carried delay line:
        # out[t] = sum_j fir[j] * seg[t+1+j] where seg = [mem(48), new(80)]
        seg = np.concatenate([self.mem_fir, sq[m - n: m]])
        filt = np.convolve(seg, NLP_FIR[::-1], mode="valid")  # (81,)
        sq[m - n: m] = filt[1:]
        self.mem_fir = seg[-NLP_NTAP:].copy()
        # decimate x5, window, power spectrum
        Fw = np.zeros(PE_FFT_SIZE, np.complex128)
        idx = np.arange(m // DEC)
        Fw[: m // DEC] = sq[idx * DEC] * (
            0.5 - 0.5 * np.cos(2 * PI * idx / (m // DEC - 1)))
        Fw = np.fft.ifft(Fw) * PE_FFT_SIZE      # fft(...,+1): unnormalized
        P = (Fw.real ** 2 + Fw.imag ** 2)
        lo, hi = PE_FFT_SIZE * DEC // P_MAX, PE_FFT_SIZE * DEC // P_MIN
        gmax_bin = lo + int(np.argmax(P[lo: hi + 1]))
        gmax = P[gmax_bin]
        best_f0 = self._post_process(P, gmax, gmax_bin, prev_Wo)
        self.sq[: m - n] = sq[n:]
        return FS / best_f0                      # pitch period in samples

    @staticmethod
    def _post_process(P, gmax, gmax_bin, prev_Wo):
        min_bin = PE_FFT_SIZE * DEC // P_MAX
        cmax_bin = gmax_bin
        prev_f0_bin = prev_Wo * (4000.0 / PI) * (PE_FFT_SIZE * DEC) / FS
        mult = 2
        while gmax_bin // mult >= min_bin:
            b = gmax_bin // mult
            bmin, bmax = int(0.8 * b), int(1.2 * b)
            bmin = max(bmin, min_bin)
            thresh = CNLP * 0.5 * gmax if bmin < prev_f0_bin < bmax \
                else CNLP * gmax
            sl = P[bmin: bmax + 1]
            lmax_bin = bmin + int(np.argmax(sl))
            lmax = P[lmax_bin]
            if (lmax > thresh and lmax > P[lmax_bin - 1]
                    and lmax > P[lmax_bin + 1]):
                cmax_bin = lmax_bin
            mult += 1
        return cmax_bin * FS / (PE_FFT_SIZE * DEC)


# --- sinusoidal analysis (sine.c) -------------------------------------------
def _dft_speech(Sn):
    x = np.zeros(FFT_ENC)
    x[: NW // 2] = Sn[M // 2: M // 2 + NW // 2] * _w[M // 2: M // 2 + NW // 2]
    x[FFT_ENC - NW // 2:] = (Sn[M // 2 - NW // 2: M // 2]
                             * _w[M // 2 - NW // 2: M // 2])
    return np.fft.fft(x)                          # fft(...,-1)


def _hs_pitch_refinement(Wo, Sw, dlo, dhi, pstep):
    """sine.c hs_pitch_refinement, mirroring the C's float32 arithmetic:
    L is recomputed from the CURRENT Wo at each stage (model->L =
    PI/model->Wo inside the C function), the candidate grid accumulates
    ``p += pstep`` in float32 (whether the endpoint survives ``p <= pmax``
    depends on those roundings — with float64 + epsilon the last candidate
    can be wrongly included, flipping ~5%% of pitch indices), and harmonic
    bins use the float32 products.  Byte-exactness vs the compiled
    reference is asserted in tests/test_vocoder_codec2.py."""
    # C promotion rules matter: TWO_PI/PI are double literals, so
    # pmin/pmax/Wo come from DOUBLE divisions truncated to float, while the
    # loop accumulates p in float — whether the last grid point survives
    # ``p <= pmax`` hangs on those exact roundings.
    f32 = np.float32
    Wo = f32(Wo)
    L = int(PI / float(Wo))                      # (int)(double PI / float)
    P = (Sw.real ** 2 + Sw.imag ** 2).astype(np.float64)
    r = f32(TWO_PI / float(FFT_ENC))
    m = np.arange(1, L + 1, dtype=np.float32)
    p0d = TWO_PI / float(Wo)                     # double
    p = f32(p0d + dlo)
    pmax = f32(p0d + dhi)
    pstep = f32(pstep)
    best, Em = Wo, 0.0
    while p <= pmax:
        cand = f32(TWO_PI / float(p))            # float Wo = TWO_PI/p
        b = np.floor((m * cand / r).astype(np.float64) + 0.5).astype(int)
        E = float(np.sum(P[np.clip(b, 0, FFT_ENC - 1)]))
        if E > Em:
            Em, best = E, cand
        p = f32(p + pstep)
    return float(best)


def _two_stage_pitch_refinement(Wo, Sw):
    Wo = _hs_pitch_refinement(Wo, Sw, -5.0, 5.0, 1.0)
    Wo = _hs_pitch_refinement(Wo, Sw, -1.0, 1.0, 0.25)
    Wo = min(max(Wo, TWO_PI / P_MAX), TWO_PI / P_MIN)
    return Wo, int(np.floor(PI / Wo))


def _estimate_amplitudes(Wo, L, Sw):
    r = TWO_PI / FFT_ENC
    m = np.arange(1, L + 1)
    am = np.floor((m - 0.5) * Wo / r + 0.5).astype(int)
    bm = np.floor((m + 0.5) * Wo / r + 0.5).astype(int)
    b = np.floor(m * Wo / r + 0.5).astype(int)
    P = Sw.real ** 2 + Sw.imag ** 2
    cs = np.concatenate([[0.0], np.cumsum(P)])
    A = np.sqrt(cs[bm] - cs[am])
    phi = np.arctan2(Sw[b].imag, Sw[b].real)
    return np.concatenate([[0.0], A]), np.concatenate([[0.0], phi])


def _est_voicing_mbe(model: Model, Sw, prev_Wo):
    L, Wo, A = model.L, model.Wo, model.A
    sig = np.sum(A[1: L // 4 + 1] ** 2)
    error = 0.0
    for l in range(1, L // 4 + 1):
        al = int(np.ceil((l - 0.5) * Wo * FFT_ENC / TWO_PI))
        bl = int(np.ceil((l + 0.5) * Wo * FFT_ENC / TWO_PI))
        ms = np.arange(al, bl)
        off = (FFT_ENC // 2 + ms - l * Wo * FFT_ENC / TWO_PI + 0.5
               ).astype(int)
        Wr = _W[off]
        Am = np.sum(Sw[ms] * np.conj(Wr)) / np.sum(Wr.real ** 2
                                                   + Wr.imag ** 2)
        Ew = Sw[ms] - Am * Wr
        error += float(np.sum(Ew.real ** 2 + Ew.imag ** 2))
    snr = 10 * np.log10(sig / error) if error > 0 else 100.0
    voiced = 1 if snr > V_THRESH else 0
    elow = np.sum(A[1: L // 2 + 1] ** 2)
    ehigh = np.sum(A[L // 2: L + 1] ** 2)
    eratio = 10 * np.log10(elow / ehigh) if ehigh > 0 else 100.0
    if voiced == 0 and eratio > 10.0:
        voiced = 1
    if voiced == 1:
        if eratio < -10.0:
            voiced = 0
        dF0 = (Wo - prev_Wo) * FS / TWO_PI
        if abs(dF0) > 15.0:
            voiced = 0
        if eratio < -4.0 and Wo <= 60.0 * TWO_PI / FS:
            voiced = 0
    return model._replace(voiced=voiced)


# --- LPC / LSP (lpc.c, lsp.c) -----------------------------------------------
def _levinson_durbin(R, order):
    a = np.zeros(order + 1)
    a[0] = 1.0
    E = R[0]
    prev = np.zeros(order + 1)
    prev[0] = 1.0
    for i in range(1, order + 1):
        s = np.sum(prev[1:i] * R[i - 1: 0: -1])
        k = -(R[i] + s) / E if E != 0 else 0.0
        if abs(k) > 1.0:
            k = 0.0
        cur = prev.copy()
        cur[i] = k
        cur[1:i] = prev[1:i] + k * prev[i - 1: 0: -1]
        E = (1 - k * k) * E
        prev = cur
    return prev


def _cheb_eval(coef, x, m):
    T = np.zeros(m // 2 + 1)
    T[0], T[1] = 1.0, x
    for i in range(2, m // 2 + 1):
        T[i] = 2 * x * T[i - 1] - T[i - 2]
    return float(np.sum(coef[::-1] * T))


def _lpc_to_lsp(a, order, nb=5, delta=0.01):
    m = order // 2
    Pp = np.zeros(m + 1)
    Qp = np.zeros(m + 1)
    Pp[0] = Qp[0] = 1.0
    for i in range(1, m + 1):
        Pp[i] = a[i] + a[order + 1 - i] - Pp[i - 1]
        Qp[i] = a[i] - a[order + 1 - i] + Qp[i - 1]
    Pp[:m] *= 2.0
    Qp[:m] *= 2.0
    freq = np.zeros(order)
    roots = 0
    xl, xr = 1.0, 0.0
    xm = 0.0
    for j in range(order):
        pt = Qp if (j % 2) else Pp
        psuml = _cheb_eval(pt, xl, order)
        flag = True
        while flag and xr >= -1.0:
            xr = xl - delta
            psumr = _cheb_eval(pt, xr, order)
            tr, txr = psumr, xr
            if psumr * psuml < 0.0:
                roots += 1
                for _ in range(nb + 1):
                    xm = (xl + xr) / 2
                    psumm = _cheb_eval(pt, xm, order)
                    if psumm * psuml > 0:
                        psuml, xl = psumm, xm
                    else:
                        psumr, xr = psumm, xm
                freq[j] = xm
                xl = xm
                flag = False
            else:
                psuml, xl = tr, txr
        if flag:
            break
    return np.arccos(np.clip(freq, -1, 1)), roots


def _lsp_to_lpc(lsp, order):
    m = order // 2
    freq = np.cos(lsp)
    Wp = np.zeros(4 * m + 2)
    ak = np.zeros(order + 1)
    xin1 = xin2 = 1.0
    for j in range(order + 1):
        for i in range(m):
            n1 = 4 * i
            xout1 = xin1 - 2 * freq[2 * i] * Wp[n1] + Wp[n1 + 1]
            xout2 = xin2 - 2 * freq[2 * i + 1] * Wp[n1 + 2] + Wp[n1 + 3]
            Wp[n1 + 1] = Wp[n1]
            Wp[n1 + 3] = Wp[n1 + 2]
            Wp[n1] = xin1
            Wp[n1 + 2] = xin2
            xin1, xin2 = xout1, xout2
        xout1 = xin1 + Wp[4 * m]
        xout2 = xin2 - Wp[4 * m + 1]
        ak[j] = (xout1 + xout2) * 0.5
        Wp[4 * m] = xin1
        Wp[4 * m + 1] = xin2
        xin1 = xin2 = 0.0
    return ak


# --- quantisation (quantise.c) ----------------------------------------------
def _speech_to_uq_lsps(Sn):
    Wn = Sn * _w
    R = np.array([np.sum(Wn[: M - j] * Wn[j:]) for j in range(LPC_ORD + 1)])
    ak = _levinson_durbin(R, LPC_ORD)
    E = float(np.sum(ak * R))
    lsp, roots = _lpc_to_lsp(ak, LPC_ORD)
    if roots != LPC_ORD:
        lsp = (PI / LPC_ORD) * np.arange(LPC_ORD)
    return lsp, E


def _encode_lsps(lsps):
    lsp_hz = (4000.0 / PI) * lsps
    return [int(np.argmin((cb - lsp_hz[i]) ** 2))
            for i, cb in enumerate(LSP_CB)]


def _decode_lsps(idx):
    lsp_hz = np.array([LSP_CB[i][idx[i]] for i in range(LPC_ORD)])
    return (PI / 4000.0) * lsp_hz


def _bw_expand_lsps(lsp):
    lsp = lsp.copy()
    for i in range(1, 5):
        if lsp[i] - lsp[i - 1] < PI * (12.5 / 4000.0):
            lsp[i] = lsp[i - 1] + PI * (12.5 / 4000.0)
    for i in range(5, 8):
        if lsp[i] - lsp[i - 1] < PI * (25.0 / 4000.0):
            lsp[i] = lsp[i - 1] + PI * (25.0 / 4000.0)
    for i in range(8, LPC_ORD):
        if lsp[i] - lsp[i - 1] < PI * (75.0 / 4000.0):
            lsp[i] = lsp[i - 1] + PI * (75.0 / 4000.0)
    return lsp


def _encode_Wo(Wo):
    lo, hi = TWO_PI / P_MAX, TWO_PI / P_MIN
    return int(np.clip(np.floor(WO_LEVELS * (Wo - lo) / (hi - lo) + 0.5),
                       0, WO_LEVELS - 1))


def _decode_Wo(index):
    # quantise.c decode_Wo computes in float32; the rounding direction of
    # Wo decides L = (int)(PI/Wo) at harmonic-count boundaries (e.g.
    # f32(TWO_PI/160) > exact -> L = 79 not 80), and L gates how many
    # rand() draws the synthesis consumes — so f32 semantics are load-
    # bearing for decode exactness.
    f32 = np.float32
    lo, hi = f32(TWO_PI / P_MAX), f32(TWO_PI / P_MIN)
    step = f32((hi - lo) / f32(WO_LEVELS))
    return float(f32(lo + step * f32(index)))


def _encode_energy(e):
    e_db = 10 * np.log10(max(e, 1e-30))
    return int(np.clip(np.floor(
        E_LEVELS * (e_db - E_MIN_DB) / (E_MAX_DB - E_MIN_DB) + 0.5),
        0, E_LEVELS - 1))


def _decode_energy(index):
    step = (E_MAX_DB - E_MIN_DB) / E_LEVELS
    return 10 ** ((E_MIN_DB + step * index) / 10.0)


def _aks_to_M2(ak, Wo, L, E):
    Aw = np.fft.fft(ak, FFT_DEC)
    Pw = E / (Aw.real ** 2 + Aw.imag ** 2)[: FFT_DEC // 2]
    r = TWO_PI / FFT_DEC
    m = np.arange(1, L + 1)
    am = np.floor((m - 0.5) * Wo / r + 0.5).astype(int)
    bm = np.floor((m + 0.5) * Wo / r + 0.5).astype(int)
    cs = np.concatenate([[0.0], np.cumsum(Pw)])
    A = np.sqrt(np.maximum(cs[np.clip(bm, 0, FFT_DEC // 2)]
                           - cs[np.clip(am, 0, FFT_DEC // 2)], 0))
    return np.concatenate([[0.0], A])


def _apply_lpc_correction(A, Wo):
    if Wo < PI * 150.0 / 4000 and len(A) > 1:
        A = A.copy()
        A[1] *= 0.032
    return A


# --- phase synthesis / postfilter / synthesis (phase.c etc.) -----------------
BG_THRESH, BG_BETA = 40.0, 0.1


def _aks_to_H(ak, Wo, L):
    Aw = np.fft.fft(ak, FFT_DEC)       # fft(...,-1)
    r = TWO_PI / FFT_DEC
    m = np.arange(1, L + 1)
    am = np.floor((m - 0.5) * Wo / r + 0.5).astype(int)
    bm = np.floor((m + 0.5) * Wo / r + 0.5).astype(int)
    b = np.floor(m * Wo / r + 0.5).astype(int)
    Pw = 1.0 / (Aw.real ** 2 + Aw.imag ** 2)
    cs = np.concatenate([[0.0], np.cumsum(Pw[: FFT_DEC])])
    Em = cs[bm] - cs[am]
    Am = np.sqrt(np.abs(Em / np.maximum(bm - am, 1)))
    phi = -np.arctan2(Aw[b].imag, Aw[b].real)
    return np.concatenate([[0.0 + 0j], Am * np.exp(1j * phi)])


class GlibcRand:
    """glibc's default rand() (TYPE_3 additive-feedback trinomial
    x^31 + x^3 + 1), seed 1 — the stream the reference decoder consumes
    via libc rand() in phase.c/postfilter.c.  Verified value-exact against
    a compiled reference (tests assert the resulting decode equality)."""

    def __init__(self, seed: int = 1):
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            r[i] = (16807 * r[i - 1]) % 2147483647
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._r = r
        self._i = 344

    def __call__(self) -> int:
        r = self._r
        v = (r[self._i - 31] + r[self._i - 3]) & 0xFFFFFFFF
        r.append(v)
        self._i += 1
        return v >> 1

    def uniform(self, n: int) -> np.ndarray:
        """n draws of (double)rand()/RAND_MAX in C call order."""
        return np.array([self() for _ in range(n)], np.float64) / 2147483647.0


class _Codec2State:
    def __init__(self, rng_seed=1):
        self.Sn = np.ones(M)
        self.Sn_ = np.zeros(2 * N)
        self.nlp = Nlp()
        self.prev_Wo = 0.0
        self.bg_est = 0.0
        self.ex_phase = 0.0
        self.prev_model = Model(TWO_PI / P_MAX, int(P_MAX / 2),
                                np.zeros(int(P_MAX / 2) + 1),
                                np.zeros(int(P_MAX / 2) + 1), 0)
        self.prev_lsps = np.arange(LPC_ORD) * PI / (LPC_ORD + 1)
        self.prev_energy = 1.0
        self.rng = GlibcRand(rng_seed)


def _analyse_one_frame(st: _Codec2State, speech):
    st.Sn[: M - N] = st.Sn[N:]
    st.Sn[M - N:] = speech
    Sw = _dft_speech(st.Sn)
    # C stores pitch and Wo as float32 (codec2.c analyse_one_frame); the
    # rounding of Wo seeds the refinement grid, so it must match exactly
    pitch = np.float32(st.nlp(st.Sn, st.prev_Wo))
    Wo = float(np.float32(TWO_PI / float(pitch)))
    Wo, L = _two_stage_pitch_refinement(Wo, Sw)
    A, phi = _estimate_amplitudes(Wo, L, Sw)
    model = Model(Wo, L, A, phi, 0)
    model = _est_voicing_mbe(model, Sw, st.prev_Wo)
    st.prev_Wo = model.Wo
    return model


def _phase_synth_zero_order(st: _Codec2State, model: Model, ak):
    """phase.c phase_synth_zero_order with the C's float32 arithmetic on
    everything that gates table lookups and phase values: ex_phase is a
    float accumulator, the glottal bin and the cos/sin arguments are
    float expressions (promoted to double only inside cos/sin)."""
    f32 = np.float32
    H = _aks_to_H(ak, model.Wo, model.L)
    Wo32 = f32(model.Wo)
    ex = f32(f32(st.ex_phase) + f32(Wo32 * f32(N)))
    ex = f32(ex - f32(TWO_PI * np.floor(float(ex) / TWO_PI + 0.5)))
    st.ex_phase = float(ex)
    m = np.arange(1, model.L + 1)
    if model.voiced:
        # one rand() per harmonic (phase.c:232 draws jitter INSIDE the m
        # loop), consuming the libc stream in the reference's exact order
        jitter = (0.25 * (1.0 - 2.0 * st.rng.uniform(model.L))).astype(f32)
        r32 = f32(TWO_PI / 512.0)
        mb = (m.astype(f32) * Wo32 / r32).astype(np.float64) + 0.5
        b = np.minimum(np.floor(mb).astype(int), 255)
        arg = (f32(ex) * m.astype(f32)
               - (jitter * Wo32) * m.astype(f32)
               + GLOTTAL.astype(f32)[b]).astype(np.float64)
        Ex = np.exp(1j * arg)
    else:
        phi = (TWO_PI * st.rng.uniform(model.L)).astype(f32)
        Ex = np.exp(1j * phi.astype(np.float64))
    A_ = H[1:] * Ex
    phi = np.arctan2(A_.imag, A_.real + 1e-12)
    return model._replace(phi=np.concatenate([[0.0], phi]))


def _postfilter(st: _Codec2State, model: Model):
    if model.L == 0:
        return model
    e = 10 * np.log10(np.sum(model.A[1:] ** 2) / model.L + 1e-30)
    if e < BG_THRESH and not model.voiced:
        st.bg_est = st.bg_est * (1 - BG_BETA) + e * BG_BETA
    if model.voiced:
        low = 20 * np.log10(np.maximum(model.A[1:], 1e-30)) < st.bg_est
        if low.any():
            # rand() consumed only for the masked harmonics, ascending m
            # (postfilter.c:125) — assignment order IS the stream order
            phi = model.phi.copy()
            phi[1:][low] = TWO_PI * st.rng.uniform(int(low.sum()))
            model = model._replace(phi=phi)
    return model


def _synthesise(st: _Codec2State, model: Model):
    st.Sn_[: N - 1] = st.Sn_[N: 2 * N - 1]
    st.Sn_[N - 1:] = 0.0
    Sw = np.zeros(FFT_DEC, np.complex128)
    if model.L > 0:
        # sine.c synthesise: b = floor(l*Wo*FFT_DEC/TWO_PI + 0.5) with the
        # l*Wo*FFT_DEC product in float32 (bin boundaries flip vs float64)
        f32 = np.float32
        l = np.arange(1, model.L + 1)
        prod = (l.astype(f32) * f32(model.Wo) * f32(FFT_DEC)).astype(
            np.float64)
        b = np.minimum(np.floor(prod / TWO_PI + 0.5).astype(int),
                       FFT_DEC // 2 - 1)
        vals = model.A[1:] * np.exp(1j * model.phi[1:])
        Sw[b] = vals             # assignment (last harmonic wins), as in C
        Sw[FFT_DEC - b] = np.conj(vals)
    sw = (np.fft.ifft(Sw) * FFT_DEC).real       # fft(...,+1) unnormalized
    st.Sn_[: N - 1] += sw[FFT_DEC - N + 1:] * _Pn[: N - 1]
    st.Sn_[N - 1:] = sw[: N + 1] * _Pn[N - 1:]
    return np.clip(st.Sn_[:N], -32767, 32767).astype(np.int16)


def _synthesise_one_frame(st: _Codec2State, model: Model, ak):
    model = _phase_synth_zero_order(st, model, ak)
    model = _postfilter(st, model)
    return _synthesise(st, model)


# --- bit packing (pack.c: Gray-coded, MSB-first) -----------------------------
_FIELD_WIDTHS = [WO_BITS] + LSP_BITS + [E_BITS, 1, 1]


def _gray(x):
    return (x >> 1) ^ x


def _ungray(g):
    x = g
    for s in (8, 4, 2, 1):
        x ^= x >> s
    return x


def _pack_frame(fields):
    bits = []
    for v, w in zip(fields, _FIELD_WIDTHS):
        g = _gray(int(v))
        bits.extend((g >> (w - 1 - i)) & 1 for i in range(w))
    bits.extend([0] * (56 - len(bits)))
    return np.packbits(np.array(bits, np.uint8))


def _unpack_frame(data7):
    bits = np.unpackbits(np.asarray(data7, np.uint8))
    fields = []
    p = 0
    for w in _FIELD_WIDTHS:
        g = 0
        for i in range(w):
            g = (g << 1) | int(bits[p + i])
        p += w
        fields.append(_ungray(g))
    return fields


# --- public codec ------------------------------------------------------------
class Codec2:
    """One full-duplex codec instance (codec2.c codec2_create)."""

    def __init__(self, seed=0):
        self.enc = _Codec2State(seed)
        self.dec = _Codec2State(seed + 1)

    def encode_frame(self, speech160) -> np.ndarray:
        """160 int16 samples -> 7 packed bytes (50 bits)."""
        s = np.asarray(speech160, np.float64)
        st = self.enc
        m1 = _analyse_one_frame(st, s[:N])
        m2 = _analyse_one_frame(st, s[N:])
        wo_i = _encode_Wo(m2.Wo)
        lsps, e = _speech_to_uq_lsps(st.Sn)
        lsp_i = _encode_lsps(lsps)
        e_i = _encode_energy(e)
        return _pack_frame([wo_i] + lsp_i + [e_i, m1.voiced, m2.voiced])

    def decode_frame(self, data7) -> np.ndarray:
        """7 packed bytes -> 160 int16 samples."""
        st = self.dec
        f = _unpack_frame(data7)
        wo_i, lsp_i, e_i, v1, v2 = f[0], f[1:11], f[11], f[12], f[13]
        Wo = _decode_Wo(wo_i)
        L = int(PI / Wo)          # (int)(double PI / float Wo)
        lsps = _bw_expand_lsps(_decode_lsps(lsp_i))
        ak = _lsp_to_lpc(lsps, LPC_ORD)
        e = _decode_energy(e_i)
        A = _apply_lpc_correction(_aks_to_M2(ak, Wo, L, e), Wo)
        model = Model(Wo, L, A, np.zeros(L + 1), v2)

        # interpolated model for the first 10ms subframe (interp.c)
        f32 = np.float32
        if v1:
            pv, nv = st.prev_model.voiced, v2
            if pv and nv:
                Wo_i = float(f32((st.prev_model.Wo + Wo) / 2.0))
            elif nv:
                Wo_i = Wo
            elif pv:
                Wo_i = st.prev_model.Wo
            else:
                Wo_i = float(P_MAX) / 2     # reference quirk: silent frame
        else:
            Wo_i = float(f32(TWO_PI / P_MAX))
        L_i = int(PI / Wo_i)
        lsps_i = (st.prev_lsps + lsps) / 2
        e_int = 10 ** ((np.log10(max(st.prev_energy, 1e-30))
                        + np.log10(max(e, 1e-30))) / 2)
        ak_i = _lsp_to_lpc(lsps_i, LPC_ORD)
        A_i = _apply_lpc_correction(_aks_to_M2(ak_i, Wo_i, L_i, e_int), Wo_i)
        model_i = Model(Wo_i, L_i, A_i, np.zeros(L_i + 1), v1)

        out = np.empty(160, np.int16)
        out[:N] = _synthesise_one_frame(st, model_i, ak_i)
        out[N:] = _synthesise_one_frame(st, model, ak)
        st.prev_model = model
        st.prev_lsps = lsps
        st.prev_energy = e
        return out

    def encode(self, speech) -> np.ndarray:
        s = np.asarray(speech)
        nf = len(s) // SAMPLES_PER_FRAME
        return np.concatenate(
            [self.encode_frame(s[i * 160:(i + 1) * 160]) for i in range(nf)])

    def decode(self, data) -> np.ndarray:
        d = np.asarray(data, np.uint8).reshape(-1, 7)
        return np.concatenate([self.decode_frame(f) for f in d])


class _HostCodecBlock(Block):
    """A block whose codec runs on the host: each chunk is copied to the
    host, coded with NumPy and copied back to the chunk's device.

    grtpu calls the codec through an ordered ``io_callback`` inside its
    jitted step.  A CUDA graph cannot hold a host callback, so these blocks
    run only in the eager executor (``run()``, ``step()``);
    ``run(device_loop=True)`` refuses a graph that holds one
    (``host_only``) before it runs anything."""

    host_only = True

    def __init__(self, name=None):
        super().__init__(name)
        self.codec = Codec2()


class Codec2Encode(_HostCodecBlock):
    """vocoder_codec2_encode_sp: 160 int16 -> one 7-byte packed frame.

    (The reference streams CODEC2_BITS_PER_FRAME=50 chars per frame of
    which only the first ceil(50/8)=7 bytes carry data; we stream the 7
    meaningful bytes as one vector item.)  The codec is the host (NumPy)
    frame codec — same placement as the reference's scalar C."""

    in_ports = (port_s(),)
    out_ports = (Port(np.uint8, vlen=7),)
    decim = 160

    def apply(self, state, x):
        out = self.codec.encode(x.cpu().numpy()).reshape(-1, 7)
        return state, torch.from_numpy(out).to(x.device)


class Codec2Decode(_HostCodecBlock):
    """vocoder_codec2_decode_ps: one 7-byte packed frame -> 160 int16."""

    in_ports = (Port(np.uint8, vlen=7),)
    out_ports = (port_s(),)
    interp = 160

    def apply(self, state, x):
        out = self.codec.decode(x.cpu().numpy())
        return state, torch.from_numpy(out).to(x.device)
