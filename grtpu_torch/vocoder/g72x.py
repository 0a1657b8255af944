"""CCITT G.721 / G.723 ADPCM codecs as per-sample recurrences over channels.

Port of ``grtpu.vocoder.g72x``.  Reference behavior:
gr-vocoder/lib/g7xx/{g72x.c,g721.c,g723_24.c,g723_40.c} (the Sun
implementation of CCITT G.721/G.723) wrapped by vocoder_g7*_encode_sb /
_decode_bs blocks (one code byte per PCM sample).

ADPCM has per-sample feedback through an adaptive quantizer and an adaptive
2-pole/6-zero predictor, so a channel is a sequential loop; grtpu runs it as
a ``lax.scan`` and vmaps channels.  Here one step is a few dozen int32 ops
over all channels at once (state leaves carry the channels on their leading
axes), run by :func:`grtpu_torch.runtime.step_graph.step_scan`: on the card
``UNROLL`` steps are one CUDA-graph replay.

Integer semantics follow grtpu's exactly: ``>>`` on int32 is an arithmetic
shift (never ``//``, which floors where C truncates), shift counts are
clamped at 0 as ``_rshift`` / ``_lshift`` do, and ``_s16`` reproduces the
C stores through ``short``.  Outputs are bit-exact against the reference's
golden vectors (tests/data/vocoder_golden.npz).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, port_b, port_s
from grtpu_torch.runtime.step_graph import step_scan
from grtpu_torch.utils.device import constant, resolve

_POWER2 = np.array([1 << k for k in range(15)], np.int32)

# Per-variant constants (g721.c:53-70, g723_24.c:46-58, g723_40.c:54-76).
_TABLES = {
    "g721": dict(
        bits=4, sign=8, mag_mask=0x3FFF, b_shift=8,
        qtab=np.array([-124, 80, 178, 246, 300, 349, 400], np.int32),
        dqln=np.array([-2048, 4, 135, 213, 273, 323, 373, 425,
                       425, 373, 323, 273, 213, 135, 4, -2048], np.int32),
        # g721 passes witab[i] << 5 to update(); pre-shift here.
        wi=np.array([-12, 18, 41, 64, 112, 198, 355, 1122,
                     1122, 355, 198, 112, 64, 41, 18, -12], np.int32) << 5,
        fi=np.array([0, 0, 0, 0x200, 0x200, 0x200, 0x600, 0xE00,
                     0xE00, 0x600, 0x200, 0x200, 0x200, 0, 0, 0], np.int32),
    ),
    "g723_24": dict(
        bits=3, sign=4, mag_mask=0x3FFF, b_shift=8,
        qtab=np.array([8, 218, 331], np.int32),
        dqln=np.array([-2048, 135, 273, 373, 373, 273, 135, -2048], np.int32),
        wi=np.array([-128, 960, 4384, 18624, 18624, 4384, 960, -128], np.int32),
        fi=np.array([0, 0x200, 0x400, 0xE00, 0xE00, 0x400, 0x200, 0], np.int32),
    ),
    "g723_40": dict(
        bits=5, sign=0x10, mag_mask=0x7FFF, b_shift=9,
        qtab=np.array([-122, -16, 68, 139, 198, 250, 298, 339,
                       378, 413, 445, 475, 502, 528, 553], np.int32),
        dqln=np.array([-2048, -66, 28, 104, 169, 224, 274, 318,
                       358, 395, 429, 459, 488, 514, 539, 566,
                       566, 539, 514, 488, 459, 429, 395, 358,
                       318, 274, 224, 169, 104, 28, -66, -2048], np.int32),
        wi=np.array([448, 448, 768, 1248, 1280, 1312, 1856, 3200,
                     4512, 5728, 7008, 8960, 11456, 14080, 16928, 22272,
                     22272, 16928, 14080, 11456, 8960, 7008, 5728, 4512,
                     3200, 1856, 1312, 1280, 1248, 768, 448, 448], np.int32),
        fi=np.array([0, 0, 0, 0, 0, 0x200, 0x200, 0x200,
                     0x200, 0x200, 0x400, 0x600, 0x800, 0xA00, 0xC00, 0xC00,
                     0xC00, 0xC00, 0xA00, 0x800, 0x600, 0x400, 0x200, 0x200,
                     0x200, 0x200, 0x200, 0, 0, 0, 0, 0], np.int32),
    ),
}


class _Consts:
    """The tables of one variant as host arrays; ``constant`` keeps one
    copy per device."""

    def __init__(self, variant):
        t = _TABLES[variant]
        self.bits, self.sign = t["bits"], t["sign"]
        self.mag_mask, self.b_shift = t["mag_mask"], t["b_shift"]
        self.nq = len(t["qtab"])
        self.qtab, self.dqln = t["qtab"], t["dqln"]
        self.wi, self.fi = t["wi"], t["fi"]
        self.power2 = _POWER2

    def on(self, device):
        """(power2, qtab, dqln, wi, fi) on ``device``."""
        return tuple(constant(self, k, device)
                     for k in ("power2", "qtab", "dqln", "wi", "fi"))


_CONSTS = {v: _Consts(v) for v in _TABLES}


def _s16(x):
    """Reproduce C assignment-through-short truncation (sign-extended)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _quan_pow2(val, p2):
    """quan(val, power2, 15): number of powers of two <= val."""
    return (val[..., None] >= p2).sum(-1, dtype=torch.int32)


def _where(c, a: int, b: int):
    """``where`` of two Python ints as int32: torch makes int64 of two
    scalars, where jnp keeps them weakly typed."""
    return torch.where(c, a, b).to(torch.int32)


def _rshift(x, n):
    return x >> n.clamp(min=0)


def _lshift(x, n):
    return x << n.clamp(min=0)


class G72xState(NamedTuple):
    """Coder state (g72x.h struct g72x_state; init per g72x_init_state).
    Every leaf is int32; a bank of channels carries them on leading axes."""
    yl: torch.Tensor    # locked step-size multiplier (32-bit)
    yu: torch.Tensor    # unlocked step-size multiplier
    dms: torch.Tensor   # short-term energy estimate
    dml: torch.Tensor   # long-term energy estimate
    ap: torch.Tensor    # yl/yu mixing speed
    a: torch.Tensor     # (..., 2) pole predictor coefficients
    b: torch.Tensor     # (..., 6) zero predictor coefficients
    pk: torch.Tensor    # (..., 2) signs of previous reconstructed samples
    dq: torch.Tensor    # (..., 6) past quantized differences (float format)
    sr: torch.Tensor    # (..., 2) past reconstructed samples (float format)
    td: torch.Tensor    # tone/transition detect flag


_LEAF = dict(a=(2,), b=(6,), pk=(2,), dq=(6,), sr=(2,))


def g72x_init_state(channels: int = None, device=None) -> G72xState:
    """The initial coder state: scalars (vectors for the predictor) as in
    grtpu, or with a leading axis of ``channels`` for a bank."""
    dev = resolve(device)
    lead = () if channels is None else (int(channels),)

    def full(v, *shape):
        return torch.full(lead + shape, v, dtype=torch.int32, device=dev)

    return G72xState(
        yl=full(34816), yu=full(544), dms=full(0), dml=full(0), ap=full(0),
        a=full(0, 2), b=full(0, 6), pk=full(0, 2), dq=full(32, 6),
        sr=full(32, 2), td=full(0))


def _fmult(an, srn, p2):
    """14-bit int x (4-bit exp, 6-bit mantissa) float product (g72x.c:65-85),
    elementwise over the 6 zero and 2 pole taps at once."""
    anmag = torch.where(an > 0, an, (-an) & 0x1FFF)
    anexp = _quan_pow2(anmag, p2) - 6
    anmant = torch.where(anmag == 0, 32,
                         torch.where(anexp >= 0, _rshift(anmag, anexp),
                                     _lshift(anmag, -anexp)))
    wanexp = anexp + ((srn >> 6) & 0xF) - 13
    wanmant = (anmant * (srn & 0x3F) + 0x30) >> 4
    retval = _s16(torch.where(wanexp >= 0,
                              _lshift(wanmant, wanexp) & 0x7FFF,
                              _rshift(wanmant, -wanexp)))
    return torch.where((an ^ srn) < 0, -retval, retval)


def _predictors(st: G72xState, p2):
    """sezi (6-zero) and sei (zero+pole) partial estimates, short-truncated."""
    an = torch.cat([st.b, st.a[..., 1:], st.a[..., :1]], -1) >> 2
    srn = torch.cat([st.dq, st.sr[..., 1:], st.sr[..., :1]], -1)
    f = _fmult(an, srn, p2)
    sezi = _s16(f[..., :6].sum(-1, dtype=torch.int32))
    pole = f[..., 6] + f[..., 7]
    sez = sezi >> 1
    se = _s16((sezi + pole) >> 1)
    return sez, se


def _step_size(st: G72xState):
    """Adaptive quantizer step (g72x.c:155-177)."""
    y = st.yl >> 6
    dif = st.yu - y
    al = st.ap >> 2
    adj = torch.where(dif > 0, (dif * al) >> 6,
                      torch.where(dif < 0, (dif * al + 0x3F) >> 6, 0))
    return torch.where(st.ap >= 256, st.yu, y + adj)


def _quantize(d, y, qtab, nq, p2):
    """Log-domain quantization of difference d (g72x.c:186-226)."""
    dqm = _s16(d.abs())
    exp = _quan_pow2(dqm >> 1, p2)
    mant = _rshift(dqm << 7, exp) & 0x7F
    dln = (exp << 7) + mant - (y >> 2)
    i = (dln[..., None] >= qtab).sum(-1, dtype=torch.int32)
    return torch.where(d < 0, (nq << 1) + 1 - i,
                       torch.where(i == 0, (nq << 1) + 1, i))


def _reconstruct(sign, dqln, y):
    """Inverse log-domain quantizer (g72x.c:234-258)."""
    dql = dqln + (y >> 2)
    dex = (dql >> 7) & 15
    dqt = 128 + (dql & 127)
    dq = _rshift(dqt << 7, 14 - dex)
    return torch.where(sign != 0,
                       torch.where(dql < 0, -0x8000, dq - 0x8000),
                       torch.where(dql < 0, 0, dq))


def _float_ab(val, neg, p2):
    """FLOAT A/B: 4-bit exponent, 6-bit mantissa encode (g72x.c:401-423)."""
    mag = val.abs()
    exp = _quan_pow2(mag, p2)
    enc = (exp << 6) + _rshift(mag << 6, exp)
    enc = torch.where(neg, enc - 0x400, enc)
    return torch.where(mag == 0, _where(neg, _s16(0xFC20), 0x20), enc)


def _update(st: G72xState, b_shift, y, wi, fi, dq, sr, dqsez, p2) -> G72xState:
    """State update common to encode/decode (g72x.c:266-455)."""
    pk0 = (dqsez < 0).to(torch.int32)
    mag = dq & 0x7FFF
    a0, a1_ = st.a[..., 0], st.a[..., 1]
    pk_0, pk_1 = st.pk[..., 0], st.pk[..., 1]

    # TRANS: tone/transition detection threshold from locked scale factor.
    ylint = st.yl >> 15
    ylfrac = (st.yl >> 10) & 0x1F
    thr1 = _lshift(32 + ylfrac, ylint)
    thr2 = torch.where(ylint > 9, 31 << 10, thr1)
    dqthr = (thr2 + (thr2 >> 1)) >> 1
    tr = torch.where(st.td == 0, 0, _where(mag <= dqthr, 0, 1))

    # FUNCTW & FILTD & LIMB & FILTE: scale-factor adaptation.
    yu = _s16(y + ((wi - y) >> 5)).clamp(544, 5120)
    yl = st.yl + yu + ((-st.yl) >> 6)

    # Adaptive predictor update (UPA2/LIMC for a2, UPA1/LIMD for a1, UPB).
    pks1 = pk0 ^ pk_0
    a2p = a1_ - (a1_ >> 7)
    fa1 = torch.where(pks1 != 0, a0, -a0)
    a2p_adj = a2p + torch.where(fa1 < -8191, -0x100,
                                torch.where(fa1 > 8191, 0xFF, fa1 >> 5))
    a2p_lim = torch.where(
        (pk0 ^ pk_1) != 0,
        torch.where(a2p_adj <= -12160, -12288,
                    torch.where(a2p_adj >= 12416, 12288, a2p_adj - 0x80)),
        torch.where(a2p_adj <= -12416, -12288,
                    torch.where(a2p_adj >= 12160, 12288, a2p_adj + 0x80)))
    a2p = torch.where(dqsez != 0, a2p_lim, a2p)

    a1 = a0 - (a0 >> 8)
    a1 = a1 + torch.where(dqsez != 0, _where(pks1 == 0, 192, -192), 0)
    a1ul = 15360 - a2p
    a1 = torch.clamp(a1, min=-a1ul, max=a1ul)

    b = st.b - (st.b >> b_shift)
    b_step = _where((dq[..., None] ^ st.dq) >= 0, 128, -128)
    b = b + torch.where(((dq & 0x7FFF) != 0)[..., None], b_step, 0)

    # TRIGB: modem (data) signal resets the whole predictor.
    is_tr = tr == 1
    a = torch.where(is_tr[..., None], 0, torch.stack([a1, a2p], -1))
    b = torch.where(is_tr[..., None], 0, b)

    # DELAY A / FLOAT A / FLOAT B.
    dq_hist = torch.cat([_float_ab(mag, dq < 0, p2)[..., None],
                         st.dq[..., :5]], -1)
    sr_hist = torch.stack([
        torch.where(sr == -32768, _s16(0xFC20), _float_ab(sr, sr < 0, p2)),
        st.sr[..., 0]], -1)
    pk = torch.stack([pk0, pk_0], -1)

    # TONE + adaptation speed control (FILTA/FILTB/SUBTC).
    td = torch.where(is_tr, 0, _where(a2p < -11776, 1, 0))
    dms = st.dms + ((fi - st.dms) >> 5)
    dml = st.dml + (((fi << 2) - st.dml) >> 7)
    fast = (y < 1536) | (td == 1) | \
        (((dms << 2) - dml).abs() >= (dml >> 3))
    ap = torch.where(is_tr, 256,
                     torch.where(fast, st.ap + ((0x200 - st.ap) >> 4),
                                 st.ap + ((-st.ap) >> 4)))

    return G72xState(yl=yl, yu=yu, dms=dms, dml=dml, ap=ap, a=a, b=b,
                     pk=pk, dq=dq_hist, sr=sr_hist, td=td)


def _encode_step(c: _Consts, tabs, st: G72xState, x):
    p2, qtab, dqln, wi, fi = tabs
    sez, se = _predictors(st, p2)
    d = _s16((x.to(torch.int32) >> 2) - se)   # 14-bit input, SUBTA
    y = _step_size(st)
    i = _quantize(d, y, qtab, c.nq, p2)
    il = i.long()
    dq = _reconstruct(i & c.sign, dqln[il], y)
    sr = _s16(torch.where(dq < 0, se - (dq & c.mag_mask), se + dq))
    dqsez = _s16(sr + sez - se)
    st = _update(st, c.b_shift, y, wi[il], fi[il], dq, sr, dqsez, p2)
    return st, i.to(torch.uint8)


def _decode_step(c: _Consts, tabs, st: G72xState, code):
    p2, qtab, dqln, wi, fi = tabs
    i = code.to(torch.int32) & ((1 << c.bits) - 1)
    il = i.long()
    sez, se = _predictors(st, p2)
    y = _step_size(st)
    dq = _reconstruct(i & c.sign, dqln[il], y)
    sr = _s16(torch.where(dq < 0, se - (dq & c.mag_mask), se + dq))
    dqsez = _s16(sr - se + sez)
    st = _update(st, c.b_shift, y, wi[il], fi[il], dq, sr, dqsez, p2)
    return st, _s16(sr << 2).to(torch.int16)


def _run(step_fn, variant, state: G72xState, xs, out_dtype):
    """Scan ``step_fn`` over the last axis of ``xs`` (..., T), whose leading
    axes are the state's channel axes."""
    c = _CONSTS[variant]
    tabs = c.on(xs.device)
    lead = tuple(state.yl.shape)
    nb = int(np.prod(lead)) if lead else 1
    flat = G72xState(*[leaf.reshape((nb,) + _LEAF.get(k, ()))
                       for k, leaf in zip(G72xState._fields, state)])
    seq = xs.reshape(nb, xs.shape[-1]).t().contiguous()
    out = torch.empty(seq.shape, dtype=out_dtype, device=xs.device)

    def step(s, x):
        s2, y = step_fn(c, tabs, G72xState(*s), x)
        return tuple(s2), y

    fin = step_scan(step, flat, seq, out)
    new = G72xState(*[leaf.reshape(lead + _LEAF.get(k, ()))
                      for k, leaf in zip(G72xState._fields, fin)])
    return new, out.t().reshape(xs.shape)


def g72x_encode(variant: str, state: G72xState, pcm):
    """Encode int16 PCM (..., T) -> one ADPCM code byte per sample
    (bit-exact); the leading axes are the state's channels."""
    return _run(_encode_step, variant, state, pcm, torch.uint8)


def g72x_decode(variant: str, state: G72xState, codes):
    """Decode ADPCM code bytes (..., T) -> int16 PCM (bit-exact)."""
    return _run(_decode_step, variant, state, codes, torch.int16)


class _G72xBlock(Block):
    _variant = None
    _encode = True
    in_ports = (port_s(),)
    out_ports = (port_b(),)

    def init_state(self):
        return g72x_init_state(device="cpu")

    def apply(self, state, x):
        fn = g72x_encode if type(self)._encode else g72x_decode
        return fn(type(self)._variant, state, x)


class G721Encode(_G72xBlock):
    """vocoder_g721_encode_sb: 32 kbit/s ADPCM (4-bit codes)."""
    _variant = "g721"


class G721Decode(_G72xBlock):
    """vocoder_g721_decode_bs."""
    _variant, _encode = "g721", False
    in_ports, out_ports = (port_b(),), (port_s(),)


class G723_24Encode(_G72xBlock):
    """vocoder_g723_24_encode_sb: 24 kbit/s ADPCM (3-bit codes)."""
    _variant = "g723_24"


class G723_24Decode(_G72xBlock):
    """vocoder_g723_24_decode_bs."""
    _variant, _encode = "g723_24", False
    in_ports, out_ports = (port_b(),), (port_s(),)


class G723_40Encode(_G72xBlock):
    """vocoder_g723_40_encode_sb: 40 kbit/s ADPCM (5-bit codes)."""
    _variant = "g723_40"


class G723_40Decode(_G72xBlock):
    """vocoder_g723_40_decode_bs."""
    _variant, _encode = "g723_40", False
    in_ports, out_ports = (port_b(),), (port_s(),)
