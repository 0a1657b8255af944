"""GSM 06.10 full-rate (RPE-LTP) codec: 160 int16 samples <-> 33-byte frames.

Port of ``grtpu.vocoder.gsm``.  Reference behavior: gr-vocoder/lib/gsm/
(libgsm 1.0, Degener/Bormann) wrapped by vocoder_gsm_fr_encode_sp /
_decode_ps (sync decimator/interpolator by 160, regular non-WAV49 packing,
gsm.h:44 GSM_MAGIC 0xD).

The codec is a per-frame recurrence; every op works on a bank of channels
at once (the state leaves carry them on a leading axis), so a frame of the
whole bank is one step of :func:`grtpu_torch.runtime.step_graph.step_scan`
(one CUDA-graph replay a frame on the card).  Inside a frame the per-sample
feedback paths of grtpu's scans are kept:
  * preprocessing (offset compensation, preemphasis) and the decoder's
    deemphasis run one sample a step, as grtpu's scans do;
  * the 8-stage short-term lattices run as wavefronts over their stages:
    stage i of sample k depends only on stage i-1 of samples k and k-1
    (analysis) or on stage i+1 of sample k and stage i-1 of sample k-1
    (synthesis), so all stages on one anti-diagonal step together — 167
    steps a frame for the analysis filter and 326 for the synthesis filter
    in place of 1280 sequential stage updates.  The integer arithmetic is
    unchanged, so the outputs are grtpu's bit for bit.
The heavy parts (autocorrelation, the 81-lag LTP search, the RPE weighting
filter) are int32 tensor ops, as in grtpu.

Bit-exactness: every 16-bit store is reproduced with an explicit ``_s16``
truncation, saturating adds with clamps, and the two quirks of the golden
build that grtpu keeps are kept here:
  * preprocess.c:96-100 GSM_L_ADD with ``(ulongword)`` casts returns
    MAX_LONGWORD for any negative sum (with nonzero second operand) —
    ``_l_add_cast``;
  * long_term.c scaling: when dmax == 0 the second `if` overwrites scal to 6
    (not 0) — ``_ltp_parameters``.
int32 sums wrap as XLA's do (``sum(dtype=int32)``); ``_norm32`` counts
leading zeros by comparison with the powers of two.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port, port_s
from grtpu_torch.runtime.step_graph import step_scan
from grtpu_torch.utils.device import constant, resolve

_MAXW, _MINW = 32767, -32768
_MAXL = 2147483647
_I32 = torch.int32

# --- tables (gsm/table.c) ---------------------------------------------------
_DLB = np.array([6554, 16384, 26214, 32767], np.int32)        # 4.3a
_QLB = np.array([3277, 11469, 21299, 32767], np.int32)        # 4.3b
_H = np.array([-134, -374, 0, 2054, 5741, 8192,
               5741, 2054, 0, -374, -134], np.int32)          # 4.4
_NRFAC = np.array([29128, 26215, 23832, 21846,
                   20165, 18725, 17476, 16384], np.int32)     # 4.5
_FAC = np.array([18431, 20479, 22527, 24575,
                 26623, 28671, 30719, 32767], np.int32)       # 4.6
# LAR quantizer constants (lpc.c Quantization_and_coding STEPs).
_LAR_A = np.array([20480, 20480, 20480, 20480,
                   13964, 15360, 8534, 9036], np.int32)
_LAR_B = np.array([0, 0, 2048, -2560, 94, -1792, -341, -1144], np.int32)
_LAR_MAC = np.array([31, 31, 15, 15, 7, 7, 3, 3], np.int32)
_LAR_MIC = np.array([-32, -32, -16, -16, -8, -8, -4, -4], np.int32)
_LAR_INVA = np.array([13107, 13107, 13107, 13107,
                      19223, 17476, 31454, 29708], np.int32)

_ZONES = ((0, 13), (13, 14), (27, 13), (40, 120))
_ZONE_OF = np.repeat(np.arange(4), [n for _, n in _ZONES])      # (160,)
# W[l, k] = hist[120 + k - (40 + l)]: all 81 candidate lag windows.
_LTP_IDX = (80 - np.arange(81))[:, None] + np.arange(40)[None, :]

# Analysis wavefront: step t runs stage i on sample t - i.
_NA = 160 + 7
_A_K = np.arange(_NA)[:, None] - np.arange(8)[None, :]           # (167, 8)
_A_ACT = (_A_K >= 0) & (_A_K < 160)
_A_ZONE = _ZONE_OF[np.clip(_A_K, 0, 159)]
# Synthesis wavefront: step t runs stage i on sample (t - 7 + i) / 2.
_NS = 2 * 159 + 8
_S_2K = np.arange(_NS)[:, None] - 7 + np.arange(8)[None, :]      # (326, 8)
_S_ACT = (_S_2K >= 0) & (_S_2K % 2 == 0) & (_S_2K < 320)
_S_ZONE = _ZONE_OF[np.clip(_S_2K // 2, 0, 159)]
_S_OUT = 7 + 2 * np.arange(160)              # step of stage 0 for sample k

# --- 33-byte frame packing (gsm_encode.c regular branch, MSB-first) ----------
_WIDTHS = np.array([6, 6, 5, 5, 4, 4, 3, 3]
                   + 4 * ([7, 2, 2, 6] + [3] * 13), np.int32)
_BIT_PARAM = np.repeat(np.arange(76), _WIDTHS)
_BIT_SHIFT = np.concatenate([np.arange(w - 1, -1, -1) for w in _WIDTHS])
_MAGIC_BITS = np.array([1, 1, 0, 1], np.int32)  # GSM_MAGIC 0xD
_BYTE_W = (1 << np.arange(7, -1, -1)).astype(np.int32)
# unpack: value[p] = sum over its bits of bit << shift
_UNPACK_W = np.zeros((264, 76), np.int32)
_UNPACK_W[np.arange(260) + 4, _BIT_PARAM] = 1 << _BIT_SHIFT


class _Consts:
    """Host tables; ``constant`` keeps one copy of each per device."""
    dlb, qlb, nrfac, fac = _DLB, _QLB, _NRFAC, _FAC
    lar_a, lar_b, lar_mac, lar_mic, lar_inva = (
        _LAR_A, _LAR_B, _LAR_MAC, _LAR_MIC, _LAR_INVA)
    ltp_idx = _LTP_IDX
    pow2 = (1 << np.arange(31)).astype(np.int32)
    a_act, a_zone = _A_ACT, _A_ZONE
    s_act, s_zone, s_out = _S_ACT, _S_ZONE, _S_OUT
    bit_param, bit_shift = _BIT_PARAM, _BIT_SHIFT.astype(np.int32)
    magic, byte_w = _MAGIC_BITS, _BYTE_W
    unpack_w = _UNPACK_W.astype(np.float64)
    grid13 = 3 * np.arange(13)
    ar40 = np.arange(40)


_C = _Consts()


def _k(name, dev):
    return constant(_C, name, dev)


# --- 16/32-bit arithmetic primitives (gsm/add.c, private.h) ------------------
def _s16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _add16(a, b):
    return torch.clamp(a + b, _MINW, _MAXW)


def _sub16(a, b):
    return torch.clamp(a - b, _MINW, _MAXW)


def _mult(a, b):
    return torch.where((a == _MINW) & (b == _MINW), _MAXW, (a * b) >> 15)


def _mult_r(a, b):
    return torch.where((a == _MINW) & (b == _MINW), _MAXW,
                       _s16((a * b + 16384) >> 15))


def _abs16(a):
    return torch.where(a < 0, torch.where(a == _MINW, _MAXW, -a), a)


def _norm32(a):
    """gsm_norm: shifts to normalize a (!=0) to bit 30 (add.c:139-152):
    clz(a or ~a) - 1, the bit length counted against the powers of two."""
    x = torch.where(a < 0, ~a, a)
    bitlen = (x[..., None] >= _k("pow2", a.device)).sum(-1, dtype=_I32)
    return torch.where(a <= -1073741824, 0, 31 - bitlen)


def _l_add_cast(a, b):
    """GSM_L_ADD((ulongword)a, (ulongword)b) as the golden build computes it:
    b == 0 -> a; negative sum (b != 0) -> MAX_LONGWORD; else saturated sum."""
    s = a + b  # int32 wraps; wrap implies true sum >= 2**31 when a,b > 0
    if isinstance(b, int):          # a positive constant
        return torch.where(s < 0, _MAXL, s)
    neg_ovf = (a < 0) & (b < 0) & (s >= 0)
    return torch.where(b == 0, a, torch.where(neg_ovf | (s < 0), _MAXL, s))


def _div16(num, denum):
    """gsm_div: 15-step restoring division, num >= 0 (add.c:206-235)."""
    div = torch.zeros_like(num)
    for _ in range(15):
        div = div << 1
        num = num << 1
        ge = num >= denum
        num = torch.where(ge, num - denum, num)
        div = div + ge.to(_I32)
    return div


def _shl(x, n):
    return x << n.clamp(min=0)


# --- 4.2.1/4.2.2 preprocessing (offset compensation + preemphasis) ----------
def _preprocess(z1, L_z2, mp, s):
    """s (B, 160) -> (z1, L_z2, mp), so (B, 160); one sample a step."""
    out = []
    for k in range(s.shape[1]):
        so_in = (s[:, k] >> 3) << 2
        s1 = so_in - z1
        msp_z = _s16(L_z2 >> 15)
        lsp = _s16(L_z2 - (msp_z << 15))
        L_s2 = (s1 << 15) + ((lsp * 32735 + 16384) >> 15)
        L_z2 = _l_add_cast(msp_z * 32735, L_s2)
        L_t = _l_add_cast(L_z2, 16384)
        msp = _mult_r(mp, -28180)
        mp = _s16(L_t >> 15)
        z1 = so_in
        out.append(_add16(mp, msp))
    return (z1, L_z2, mp), torch.stack(out, 1)


# --- 4.2.4/4.2.5 LPC analysis ------------------------------------------------
def _lpc_analysis(so):
    """Autocorrelation + Schur + LAR transform + quantization (gsm/lpc.c).

    Returns (LARc (B, 8), rescaled so)."""
    dev = so.device
    smax = _abs16(so).amax(-1)
    scalauto = torch.where(smax == 0, 0, 4 - _norm32(smax << 16))
    factor = torch.full_like(scalauto, 16384) >> (scalauto - 1).clamp(0, 3)
    scaled = (scalauto > 0)[:, None]
    s = torch.where(scaled, _mult_r(so, factor[:, None]), so)

    L_ACF = torch.stack(
        [(s[:, k:] * s[:, :160 - k]).sum(-1, dtype=_I32) << 1
         for k in range(9)], -1)
    s_out = torch.where(scaled, _s16(_shl(s, scalauto[:, None])), s)

    # Schur recursion (Reflection_coefficients, lpc.c).
    zero_acf = L_ACF[:, 0] == 0
    tnorm = _norm32(torch.where(zero_acf, 1, L_ACF[:, 0]))
    ACF = (L_ACF << tnorm[:, None]) >> 16
    P = [ACF[:, i] for i in range(9)]
    K = [None] + [ACF[:, i] for i in range(1, 8)]
    r_out = []
    dead = zero_acf
    for n in range(1, 9):
        temp = _abs16(P[1])
        dead = dead | (P[0] < temp)
        rn = _div16(temp, torch.where(P[0] == 0, 1, P[0]))
        rn = torch.where(P[1] > 0, -rn, rn)
        r_out.append(torch.where(dead, 0, rn))
        if n == 8:
            break
        P[0] = _add16(P[0], _mult_r(P[1], rn))
        for m in range(1, 9 - n):
            t2 = _mult_r(K[m], rn)
            newP = _add16(P[m + 1], t2)
            t3 = _mult_r(P[m + 1], rn)
            K[m] = _add16(K[m], t3)
            P[m] = newP
    r = torch.stack(r_out, -1)

    # Transformation to LAR.
    t = _abs16(r)
    lar = torch.where(t < 22118, t >> 1,
                      torch.where(t < 31130, t - 11059, (t - 26112) << 2))
    lar = torch.where(r < 0, -lar, lar)

    # Quantization and coding.
    q = _add16(_add16(_mult(_k("lar_a", dev), lar), _k("lar_b", dev)),
               256) >> 9
    mac, mic = _k("lar_mac", dev), _k("lar_mic", dev)
    larc = torch.where(q > mac, mac - mic, torch.where(q < mic, 0, q - mic))
    return larc, s_out


# --- 4.2.8/4.2.9 LAR decode + interpolation + rp ------------------------------
def _decode_lar(larc):
    dev = larc.device
    t1 = _add16(larc, _k("lar_mic", dev)) << 10
    t1 = _sub16(t1, _k("lar_b", dev) << 1)
    t1 = _mult_r(_k("lar_inva", dev), t1)
    return _add16(t1, t1)


def _larp_to_rp(larp):
    t = torch.where(larp < 0,
                    torch.where(larp == _MINW, _MAXW, -larp), larp)
    v = torch.where(t < 11059, t << 1,
                    torch.where(t < 20070, t + 11059, _add16(t >> 2, 26112)))
    return torch.where(larp < 0, -v, v)


def _zone_rps(prev, cur):
    """rp of the four interpolation zones (k=0..12, 13..26, 27..39,
    40..159), stacked: (B, 4, 8)."""
    z0 = _add16(_add16(prev >> 2, cur >> 2), prev >> 1)
    z1 = _add16(prev >> 1, cur >> 1)
    z2 = _add16(_add16(prev >> 2, cur >> 2), cur >> 1)
    return _larp_to_rp(torch.stack([z0, z1, z2, cur], 1))


def _short_term_analysis(u, larpp_prev, larc, so):
    """8th-order lattice analysis filter over the 4 zones (short_term.c),
    as a wavefront: at step t stage i filters sample t - i.

    Stage i of sample k reads u[i] as left by sample k-1 and the (d, s)
    pair that stage i-1 of sample k made, and leaves u[i] = s_in."""
    dev = so.device
    larpp = _decode_lar(larc)
    rp = _zone_rps(larpp_prev, larpp)                       # (B, 4, 8)
    R = _rp_table(rp, _k("a_zone", dev))                    # (B, 167, 8)
    act = _k("a_act", dev)
    feed = torch.cat([so, so.new_zeros(so.shape[0], 8)], 1)
    D = torch.cat([feed[:, :1], so.new_zeros(so.shape[0], 7)], 1)
    S = D
    out = []
    for t in range(_NA):
        Rt = R[:, t]
        nS = _add16(u, _mult_r(Rt, D))
        nD = _add16(D, _mult_r(Rt, u))
        u = torch.where(act[t], S, u)
        if t >= 7:
            out.append(nD[:, 7])
        x = feed[:, t + 1:t + 2]
        D = torch.cat([x, nD[:, :7]], 1)
        S = torch.cat([x, nS[:, :7]], 1)
    return u, larpp, torch.stack(out, 1)


def _rp_table(rp, zone):
    """(B, 4, 8) zone coefficients and a (T, 8) zone index -> (B, T, 8)."""
    b = rp.shape[0]
    idx = zone.reshape(1, -1).expand(b, -1)                 # (B, T*8)
    flat = rp.transpose(1, 2).reshape(b, 32)                # [i*4 + zone]
    lane = torch.arange(8, device=rp.device).repeat(zone.shape[0])
    return flat.gather(1, lane[None] * 4 + idx).reshape(b, -1, 8)


def _short_term_synthesis(v, larpp_prev, larc, wt):
    """8th-order lattice synthesis filter over the 4 zones, as a wavefront:
    at step t stage i filters sample (t - 7 + i) / 2 where that is whole.

    Stage i of sample k reads the sr that stage i+1 of sample k made and
    v[i] as stage i-1 of sample k-1 left it; it writes v[i+1] (stage 0
    also v[0]).  Active stages of one step are never neighbours."""
    dev = wt.device
    b = wt.shape[0]
    larpp = _decode_lar(larc)
    rrp = _zone_rps(larpp_prev, larpp)
    R = _rp_table(rrp, _k("s_zone", dev))                   # (B, 326, 8)
    act = _k("s_act", dev)
    # stage 7's input at step t: wt[t / 2] on even t
    feed = torch.stack([wt, torch.zeros_like(wt)], -1).reshape(b, 320)
    feed = torch.cat([feed, wt.new_zeros(b, _NS + 1 - 320)], 1)
    SR = torch.cat([wt.new_zeros(b, 8), feed[:, :1]], 1)     # (B, 9)
    s0 = []
    for t in range(_NS):
        Rt = R[:, t]
        vi = v[:, :8]
        s_new = _sub16(SR[:, 1:], _mult_r(Rt, vi))
        v_new = _add16(vi, _mult_r(Rt, s_new))
        m = act[t]
        v = torch.cat([torch.where(m[0], s_new[:, :1], v[:, :1]),
                       torch.where(m, v_new, v[:, 1:])], 1)
        SR = torch.cat([torch.where(m, s_new, SR[:, :8]),
                        feed[:, t + 1:t + 2]], 1)
        s0.append(s_new[:, 0])
    s = torch.stack(s0, 1).index_select(1, _k("s_out", dev))
    return v, larpp, s


# --- 4.2.11 LTP ---------------------------------------------------------------
def _ltp_parameters(d, hist):
    """LTP lag + coded gain (long_term.c Calculation_of_the_LTP_parameters).
    d (B, 40), hist (B, 120)."""
    dev = d.device
    dmax = _abs16(d).amax(-1)
    temp = torch.where(dmax == 0, 0, _norm32(dmax << 16))
    scal = torch.where(temp > 6, 0, 6 - temp)  # note: dmax==0 -> scal 6
    wt = d >> scal[:, None]

    L_res = (wt[:, None, :] * hist[:, _k("ltp_idx", dev)]).sum(
        -1, dtype=_I32)                                      # (B, 81)
    maxv, arg = L_res.max(-1)
    Nc = torch.where(maxv > 0, 40 + arg.to(_I32), 40)
    L_max = maxv.clamp(min=0)
    # (L_max << 1) >> (6 - scal), 64-bit-exact: == L_max >> (5-scal) for
    # scal<6; for scal==6 saturate the doubling (downstream only compares).
    L_max = torch.where(scal == 6,
                        torch.where(L_max >= (1 << 30), _MAXL, L_max << 1),
                        L_max >> (5 - scal).clamp(min=0))

    dp_nc = hist.gather(1, (120 - Nc).long()[:, None] + _k("ar40", dev))
    lt = dp_nc >> 3
    L_power = (lt * lt).sum(-1, dtype=_I32) << 1

    tn = _norm32(torch.where(L_power == 0, 1, L_power))
    R = (L_max << tn) >> 16
    S = (L_power << tn) >> 16
    cnt = sum((R > _mult(S, int(_DLB[i]))).to(_I32) for i in range(3))
    bc = torch.where(L_max <= 0, 0, torch.where(L_max >= L_power, 3, cnt))
    return Nc, bc, dp_nc


# --- 4.2.13-4.2.17 RPE --------------------------------------------------------
def _xmaxc_to_exp_mant(xmaxc):
    exp = torch.where(xmaxc > 15, (xmaxc >> 3) - 1, 0)
    mant = xmaxc - (exp << 3)
    zero = mant == 0
    for _ in range(3):
        c = (~zero) & (mant <= 7)
        mant = torch.where(c, (mant << 1) | 1, mant)
        exp = torch.where(c, exp - 1, exp)
    return (torch.where(zero, -4, exp), torch.where(zero, 7, mant - 8))


def _apcm_inverse(xmc, mant, exp):
    """xmc (B, 13); mant, exp (B,)."""
    temp1 = _k("fac", xmc.device)[mant.long()]
    temp2 = _sub16(6, exp)
    temp3 = torch.where(temp2 >= 1, _shl(torch.ones_like(temp2), temp2 - 1),
                        0)
    t = ((xmc << 1) - 7) << 12
    t = _mult_r(temp1[:, None], t)
    t = _add16(t, temp3[:, None])
    return t >> temp2[:, None]


def _rpe_encode(e40):
    dev = e40.device
    b = e40.shape[0]
    # Weighting filter (rpe.c Weighting_filter): 11-tap, bias 4096, >>13.
    z5 = e40.new_zeros(b, 5)
    e50 = torch.cat([z5, e40, z5], 1)
    L = 4096
    for i in range(11):
        if int(_H[i]) != 0:
            L = L + int(_H[i]) * e50[:, i:i + 40]
    x = (L >> 13).clamp(_MINW, _MAXW)

    # Grid selection: energies of the 4 candidate grids, first strict max.
    def energy(m):
        t = x[:, m::3][:, :13] >> 2
        return (t * t).sum(-1, dtype=_I32) << 1

    Mc = torch.zeros(b, dtype=_I32, device=dev)
    EM = energy(0)
    for m in range(1, 4):
        em = energy(m)
        upd = em > EM
        Mc = torch.where(upd, m, Mc)
        EM = torch.where(upd, em, EM)
    grid = Mc.long()[:, None] + _k("grid13", dev)
    xM = x.gather(1, grid)

    # APCM quantization of the block maximum.
    xmax = _abs16(xM).amax(-1)
    exp = torch.zeros_like(xmax)
    temp = xmax >> 9
    itest = torch.zeros_like(xmax, dtype=torch.bool)
    for _ in range(6):
        itest = itest | (temp <= 0)
        temp = temp >> 1
        exp = exp + (~itest).to(_I32)
    xmaxc = _add16(xmax >> (exp + 5), exp << 3)

    exp2, mant = _xmaxc_to_exp_mant(xmaxc)
    temp1 = 6 - exp2
    temp2 = _k("nrfac", dev)[mant.long()]
    t = _s16(_shl(xM, temp1[:, None]))
    xmc = (_mult(t, temp2[:, None]) >> 12) + 4

    xmp = _apcm_inverse(xmc, mant, exp2)
    ep = e40.new_zeros(b, 40).scatter(1, grid, xmp)
    return xmaxc, Mc, xmc, ep


def _rpe_decode(xmaxcr, mcr, xmcr):
    exp, mant = _xmaxc_to_exp_mant(xmaxcr)
    xmp = _apcm_inverse(xmcr, mant, exp)
    grid = mcr.long()[:, None] + _k("grid13", xmcr.device)
    return xmcr.new_zeros(xmcr.shape[0], 40).scatter(1, grid, xmp)


# --- frame coder / decoder (gsm/code.c, decode.c) ----------------------------
_ENC_LEAVES = (("z1", ()), ("L_z2", ()), ("mp", ()), ("larpp_prev", (8,)),
               ("u", (8,)), ("dp0", (120,)))
_DEC_LEAVES = (("larpp_prev", (8,)), ("v", (9,)), ("msr", ()), ("nrp", ()),
               ("drp", (120,)))


def _init(leaves, channels, device, fill=None):
    dev = resolve(device)
    lead = () if channels is None else (int(channels),)
    fill = fill or {}
    return {k: torch.full(lead + shape, fill.get(k, 0), dtype=_I32,
                          device=dev) for k, shape in leaves}


def gsm_init_encode_state(channels: int = None, device=None):
    """Encoder state: int32 leaves, with a leading axis of ``channels`` for
    a bank."""
    return _init(_ENC_LEAVES, channels, device)


def gsm_init_decode_state(channels: int = None, device=None):
    """Decoder state: int32 leaves, with a leading axis of ``channels`` for
    a bank."""
    return _init(_DEC_LEAVES, channels, device, {"nrp": 40})


def _encode_frame(state, s):
    """One frame of every channel: state leaves (B, ...), s (B, 160)."""
    z1, L_z2, mp, larpp_prev, u, hist = state
    (z1, L_z2, mp), so = _preprocess(z1, L_z2, mp, s)
    larc, so = _lpc_analysis(so)
    u, larpp, d = _short_term_analysis(u, larpp_prev, larc, so)

    qlb = _k("qlb", s.device)
    subs = []
    for k in range(4):
        dk = d[:, 40 * k:40 * (k + 1)]
        Nc, bc, dp_nc = _ltp_parameters(dk, hist)
        bp = qlb[bc.long()]
        dpp = _mult_r(bp[:, None], dp_nc)
        e = _sub16(dk, dpp)
        xmaxc, Mc, xmc, ep = _rpe_encode(e)
        hist = torch.cat([hist[:, 40:], _add16(ep, dpp)], 1)
        subs.append(torch.cat(
            [torch.stack([Nc, bc, Mc, xmaxc], -1), xmc], -1))

    new_state = (z1, L_z2, mp, larpp, u, hist)
    return new_state, torch.cat([larc] + subs, -1)


def _decode_frame(state, params):
    larpp_prev, v, msr, nrp, drp = state
    larcr = params[:, :8]
    qlb = _k("qlb", params.device)
    ar40 = _k("ar40", params.device)
    wt = []
    for k in range(4):
        sub = params[:, 8 + 17 * k: 8 + 17 * (k + 1)]
        ncr, bcr, mcr, xmaxcr, xmcr = (sub[:, 0], sub[:, 1], sub[:, 2],
                                       sub[:, 3], sub[:, 4:])
        erp = _rpe_decode(xmaxcr, mcr, xmcr)
        nr = torch.where((ncr < 40) | (ncr > 120), nrp, ncr)
        nrp = nr
        brp = qlb[bcr.long()]
        lag = drp.gather(1, (120 - nr).long()[:, None] + ar40)
        drp40 = _add16(erp, _mult_r(brp[:, None], lag))
        drp = torch.cat([drp[:, 40:], drp40], 1)
        wt.append(drp40)

    v, larpp, s = _short_term_synthesis(v, larpp_prev, larcr,
                                        torch.cat(wt, 1))
    out = []
    for k in range(160):
        tmp = _mult_r(msr, 28180)
        msr = _add16(s[:, k], tmp)
        out.append(_s16(_add16(msr, msr) & 0xFFF8))
    return (larpp, v, msr, nrp, drp), torch.stack(out, 1)


def gsm_pack(params):
    """(..., 76) int32 params -> (..., 33) uint8 frames."""
    dev = params.device
    bits = (params[..., _k("bit_param", dev)] >> _k("bit_shift", dev)) & 1
    magic = _k("magic", dev).expand(bits.shape[:-1] + (4,))
    allbits = torch.cat([magic, bits], -1)
    return (allbits.reshape(allbits.shape[:-1] + (33, 8))
            * _k("byte_w", dev)).sum(-1).to(torch.uint8)


def gsm_unpack(frames):
    """(..., 33) uint8 frames -> (..., 76) int32 params."""
    dev = frames.device
    bits = (frames[..., :, None].to(_I32) >> (7 - torch.arange(
        8, device=dev, dtype=_I32))) & 1
    bits = bits.reshape(frames.shape[:-1] + (264,))
    # exact in float64: each value is below 2**7
    return (bits.to(torch.float64) @ _k("unpack_w", dev)).to(_I32)


def _frames_scan(fn, state, leaves, xs, width, out_dtype):
    """Run ``fn`` once a frame over a bank: xs (..., n, width_in) with the
    state's channel axes leading; returns (state', out (..., n, width))."""
    lead = tuple(state[leaves[0][0]].shape[:state[leaves[0][0]].dim()
                                            - len(leaves[0][1])])
    nb = int(np.prod(lead)) if lead else 1
    flat = tuple(state[k].reshape((nb,) + shape) for k, shape in leaves)
    nf = xs.shape[-2]
    seq = xs.reshape((nb, nf) + xs.shape[-1:]).transpose(0, 1).contiguous()
    out = torch.empty((nf, nb, width), dtype=out_dtype, device=xs.device)
    fin = step_scan(fn, flat, seq, out, unroll=1)
    new = {k: v.reshape(lead + shape) for (k, shape), v in zip(leaves, fin)}
    return new, out.transpose(0, 1).reshape(lead + (nf, width))


def gsm_fr_encode(state, pcm):
    """int16 PCM (..., n*160) -> (state', uint8 frames (..., n, 33)); the
    leading axes are the state's channels.  One frame of the bank a step
    (a CUDA-graph replay on the card)."""
    frames = pcm.to(_I32).reshape(pcm.shape[:-1] + (-1, 160))
    state, params = _frames_scan(_encode_frame, state, _ENC_LEAVES, frames,
                                 76, _I32)
    return state, gsm_pack(params)


def gsm_fr_decode(state, frames):
    """uint8 frames (..., n, 33) -> (state', int16 PCM (..., n*160))."""
    params = gsm_unpack(frames)
    state, pcm = _frames_scan(_decode_frame, state, _DEC_LEAVES, params,
                              160, _I32)
    return state, pcm.reshape(pcm.shape[:-2] + (-1,)).to(torch.int16)


class GsmFrEncode(Block):
    """vocoder_gsm_fr_encode_sp: 160 int16 samples -> one 33-byte frame."""

    in_ports = (port_s(),)
    out_ports = (Port(torch.uint8, vlen=33),)
    decim = 160

    def init_state(self):
        return gsm_init_encode_state(device="cpu")

    def apply(self, state, x):
        return gsm_fr_encode(state, x)


class GsmFrDecode(Block):
    """vocoder_gsm_fr_decode_ps: one 33-byte frame -> 160 int16 samples."""

    in_ports = (Port(torch.uint8, vlen=33),)
    out_ports = (port_s(),)
    interp = 160

    def init_state(self):
        return gsm_init_decode_state(device="cpu")

    def apply(self, state, x):
        return gsm_fr_decode(state, x)
