"""FLEX pager receiver components.

Port of ``grtpu.models.pager``: ``PagerSlicer`` is a tensor block; the bit
layer (BCH, FLEX interleave, sync, parsing) is grtpu's host NumPy code,
of which this module keeps its own copy.

Analogs (gr-pager, SURVEY.md §2.8): pager_slicer_fb (4-level slicer),
pager_flex_sync (sync-word detection + speed), pager_flex_deinterleave
(8x32-bit block deinterleaver), BCH(31,21) decode, pager_flex_parse
(frame/address/alpha message parsing).

The symbol-rate front end (FM demod + filtering) reuses the analog blocks;
this module covers the bit layer.  Word layout follows the FLEX convention:
32-bit words = 21 info + 10 BCH(31,21) checks + 1 even parity, transmitted
LSB-first, interleaved in blocks of 8 words.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port

# FLEX 1600 sync "A" word (BS1 + A1 pattern); detection by correlation.
FLEX_SYNC_1600 = 0xA6C6AAAA
# BCH(31,21) generator polynomial x^10+x^9+x^8+x^6+x^5+x^3+1
_BCH_POLY = 0b11101101001


class PagerSlicer(Block):
    """pager_slicer_fb: 4-level FSK baseband -> 2-bit symbols.

    FLEX symbol mapping (freq high->low): 10, 11, 01, 00 — here the
    standard slicing of the filtered discriminator output with an adaptive
    envelope (simplified to fixed thresholds at 0 and +-2/3 of max level).
    """

    def __init__(self, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)

    def apply(self, state, x):
        hi = (x > 0).to(torch.uint8)
        inner = (x.abs() <= 2.0 / 3.0).to(torch.uint8)
        # FLEX dibit: MSB = sign, LSB = inner level
        # (+3 -> 10, +1 -> 11, -1 -> 01, -3 -> 00)
        return state, (hi << 1) | inner


# ------------------------------------------------------------------ BCH
def _bch_encode_word(info21: int) -> int:
    """21 info bits -> 31-bit codeword (info << 10 | checks)."""
    reg = info21 << 10
    for i in range(30, 9, -1):
        if (reg >> i) & 1:
            reg ^= _BCH_POLY << (i - 10)
    return (info21 << 10) | (reg & 0x3FF)


def flex_encode_word(info21: int) -> int:
    """Full 32-bit FLEX word: BCH codeword + even parity bit."""
    cw = _bch_encode_word(info21)
    parity = bin(cw).count("1") & 1
    return (cw << 1) | parity


def _syndrome(cw31: int) -> int:
    reg = cw31
    for i in range(30, 9, -1):
        if (reg >> i) & 1:
            reg ^= _BCH_POLY << (i - 10)
    return reg & 0x3FF


def _build_syndrome_table():
    """syndrome -> error mask for all 1- and 2-bit error patterns."""
    table = {}
    for i in range(31):
        e = 1 << i
        table[_syndrome(e)] = e
    for i in range(31):
        for j in range(i + 1, 31):
            e = (1 << i) | (1 << j)
            s = _syndrome(e)
            table.setdefault(s, e)
    return table


_SYN_TABLE = _build_syndrome_table()


def bch_decode_word(cw31: int) -> Tuple[Optional[int], int]:
    """Correct up to 2 bit errors; returns (info21 or None, n_corrected)."""
    s = _syndrome(cw31)
    if s == 0:
        return cw31 >> 10, 0
    e = _SYN_TABLE.get(s)
    if e is None:
        return None, -1
    fixed = cw31 ^ e
    if _syndrome(fixed) != 0:
        return None, -1
    return fixed >> 10, bin(e).count("1")


def flex_decode_word(word32: int) -> Tuple[Optional[int], int]:
    """32-bit word (codeword<<1 | parity) -> (info21, n_corrected)."""
    cw = word32 >> 1
    return bch_decode_word(cw)


# ----------------------------------------------------------- interleaving
def flex_interleave(words: np.ndarray) -> np.ndarray:
    """8 x 32-bit words -> 256 bits, bit i of word j at position i*8+j
    (pager_flex_deinterleave's inverse)."""
    w = np.asarray(words, np.uint64)
    assert len(w) == 8
    bits = np.zeros(256, np.uint8)
    for i in range(32):
        for j in range(8):
            bits[i * 8 + j] = (w[j] >> i) & 1
    return bits


def flex_deinterleave(bits: np.ndarray) -> np.ndarray:
    """256 bits -> 8 x 32-bit words (pager_flex_deinterleave)."""
    b = np.asarray(bits, np.uint64)
    words = np.zeros(8, np.uint64)
    for i in range(32):
        for j in range(8):
            words[j] |= b[i * 8 + j] << i
    return words


def find_sync(bits: np.ndarray, sync: int = FLEX_SYNC_1600,
              max_errors: int = 2) -> Optional[int]:
    """Correlate for the 32-bit sync word (pager_flex_sync); returns the
    index just past the sync, or None."""
    pat = np.array([(sync >> (31 - i)) & 1 for i in range(32)], np.int8)
    b = np.asarray(bits, np.int8)
    if len(b) < 32:
        return None
    s = 2 * b - 1
    c = 2 * pat - 1
    corr = np.correlate(s, c, mode="valid")
    errs = (32 - corr) // 2
    hits = np.nonzero(errs <= max_errors)[0]
    if len(hits) == 0:
        return None
    return int(hits[0]) + 32


# ------------------------------------------------------------ frame parse
# Page vector types (pageri_flex_modes.h:43-54) and the numeric digit
# alphabet (pageri_flex_modes.cc flex_bcd).
FLEX_SECURE = 0
FLEX_UNKNOWN = 1
FLEX_TONE = 2
FLEX_STANDARD_NUMERIC = 3
FLEX_SPECIAL_NUMERIC = 4
FLEX_ALPHANUMERIC = 5
FLEX_BINARY = 6
FLEX_NUMBERED_NUMERIC = 7

FLEX_BCD = "0123456789 U -]["
FLEX_PAGE_DESC = ["ENC", "UNK", "TON", "NUM", "SPN", "ALN", "BIN", "NNM"]

_NUMERIC_TYPES = (FLEX_STANDARD_NUMERIC, FLEX_SPECIAL_NUMERIC,
                  FLEX_NUMBERED_NUMERIC)
_ALPHA_TYPES = (FLEX_ALPHANUMERIC, FLEX_SECURE)


def parse_capcode(aw1: int, aw2: int = 0) -> Tuple[int, bool]:
    """Address word(s) -> (capcode, is_long_address)
    (pager_flex_parse.cc::parse_capcode)."""
    laddr = aw1 < 0x008001 or aw1 > 0x1E0000
    if laddr:
        capcode = aw1 + ((aw2 ^ 0x1FFFFF) << 15) + 0x1F9000
    else:
        capcode = aw1 - 0x8000
    return capcode, laddr


def parse_numeric(words: List[int], page_type: int = FLEX_STANDARD_NUMERIC
                  ) -> str:
    """Numeric page payload -> digit string
    (pager_flex_parse.cc::parse_numeric semantics).

    Each 21-bit message word streams LSB-first through a 4-bit shift
    register; a digit is emitted every 4 bits.  The first emission is
    delayed past the message header: 2 bits for standard/special numeric,
    12 bits (2 + the 10-bit message-number field) for numbered numeric.
    Digit 0xC is fill and is skipped.
    """
    skip = 10 if page_type == FLEX_NUMBERED_NUMERIC else 2
    out = []
    digit = 0
    count = 4 + skip
    for w in words:
        dw = int(w)
        for _ in range(21):
            digit = ((digit >> 1) | ((dw & 1) << 3)) & 0xF
            dw >>= 1
            count -= 1
            if count == 0:
                if digit != 0x0C:
                    out.append(FLEX_BCD[digit])
                count = 4
    return "".join(out)


def pack_numeric(msg: str, page_type: int = FLEX_STANDARD_NUMERIC,
                 header: int = 0) -> List[int]:
    """Inverse of :func:`parse_numeric` for test synthesis: digit string ->
    21-bit message words (header bits first, digits 4 bits LSB-first,
    fill-digit padded)."""
    skip = 10 if page_type == FLEX_NUMBERED_NUMERIC else 2
    bits = [(header >> k) & 1 for k in range(skip)]
    for ch in msg:
        d = FLEX_BCD.index(ch)
        bits.extend(((d >> k) & 1 for k in range(4)))
    nwords = -(-len(bits) // 21)
    while len(bits) + 4 <= nwords * 21:
        bits.extend(((0x0C >> k) & 1 for k in range(4)))  # fill digit
    bits.extend([0] * (nwords * 21 - len(bits)))
    words = []
    for i in range(nwords):
        w = 0
        for k in range(21):
            w |= bits[i * 21 + k] << k
        words.append(w)
    return words


def parse_frame(datawords: List[int]) -> List[dict]:
    """One FLEX frame (88 decoded 21-bit data words per phase) -> pages
    (pager_flex_parse.cc::parse_data).

    Word 0 is the block information word: vector-field start at bits 15-10,
    address-field start at bits 9-8 (+1).  Each address word (pair, if
    long) pairs with a vector information word giving the page type and the
    message word span; the span is dispatched per type.  Returns a list of
    ``{"capcode", "type", "desc", "content"}`` dicts.
    """
    dw = [int(w) for w in datawords]
    biw = dw[0]
    if biw in (0, 0x1FFFFF):
        return []
    voffset = (biw >> 10) & 0x3F
    aoffset = ((biw >> 8) & 0x03) + 1
    pages = []
    i = aoffset
    while i < voffset:
        j = voffset + i - aoffset
        # a noise-corrupted BIW can claim vector offsets past the frame;
        # the reference reads in-bounds garbage and emits nothing useful —
        # here out-of-range entries are skipped explicitly
        if j + 1 >= len(dw) or i + 1 >= len(dw):
            break
        if dw[i] in (0, 0x1FFFFF):  # idle codeword
            i += 1
            continue
        capcode, laddr = parse_capcode(dw[i], dw[i + 1])
        if laddr:
            i += 1
        if capcode < 0:
            i += 1
            continue
        viw = dw[j]
        ptype = (viw >> 4) & 0x7
        mw1 = (viw >> 7) & 0x7F
        length = (viw >> 14) & 0x7F
        if ptype in _NUMERIC_TYPES:
            length &= 0x07
        mw2 = mw1 + length
        if mw1 == 0 and mw2 == 0:
            i += 1
            continue
        if ptype == FLEX_TONE:
            mw1 = mw2 = 0
        if mw1 > 87 or mw2 > 87:
            i += 1
            continue
        content = ""
        if ptype in _ALPHA_TYPES:
            content = _parse_alpha_span(dw, mw1, mw2 - 1, j, laddr)
        elif ptype in _NUMERIC_TYPES:
            # message words: first from the span (short address) or the
            # second vector word (long address), then the rest of the span
            if laddr:
                span = [dw[j + 1]] + dw[mw1:mw2]
            else:
                span = dw[mw1:mw2 + 1]
            content = parse_numeric(span, ptype)
        pages.append({"capcode": capcode, "type": ptype,
                      "desc": FLEX_PAGE_DESC[ptype], "content": content})
        i += 1
    return pages


def _parse_alpha_span(dw: List[int], mw1: int, mw2: int, j: int,
                      laddr: bool) -> str:
    """Alphanumeric span -> text (pager_flex_parse.cc::parse_alphanumeric:
    fragment header in the first message word — or the second vector word
    for long addresses — and 0x03 is fill)."""
    if not laddr:
        frag = (dw[mw1] >> 11) & 0x03
        mw1 += 1
    else:
        frag = (dw[j + 1] >> 11) & 0x03
        mw2 -= 1
    chars = []
    for i in range(mw1, mw2 + 1):
        w = dw[i]
        if i > mw1 or frag != 0x03:
            c = w & 0x7F
            if c != 0x03:
                chars.append(chr(c))
        for sh in (7, 14):
            c = (w >> sh) & 0x7F
            if c != 0x03:
                chars.append(chr(c))
    return "".join(chars)


class FlexParse:
    """pager_flex_parse block surface: feed decoded data words; every 88
    accumulated words is parsed as one frame and its pages appended to
    :attr:`pages` (pager_flex_parse.cc::work)."""

    FRAME_WORDS = 88

    def __init__(self, freq: float = 0.0):
        self.freq = freq
        self._buf: List[int] = []
        self.pages: List[dict] = []

    def feed(self, words) -> List[dict]:
        """Accepts any iterable of ints; returns pages newly completed."""
        new: List[dict] = []
        for w in np.asarray(words, np.int64).ravel():
            self._buf.append(int(w))
            if len(self._buf) == self.FRAME_WORDS:
                for p in parse_frame(self._buf):
                    p["freq"] = self.freq
                    new.append(p)
                self._buf.clear()
        self.pages.extend(new)
        return new


def parse_alpha(words: List[int]) -> str:
    """Alphanumeric vector payload: 7-bit chars packed 3 per 21-bit word
    (pager_flex_parse alpha handling)."""
    chars = []
    for w in words:
        for k in range(3):
            c = (w >> (7 * k)) & 0x7F
            if c:
                chars.append(chr(c))
    return "".join(chars)


def pack_alpha(msg: str) -> List[int]:
    words = []
    data = [ord(c) & 0x7F for c in msg]
    while data:
        chunk, data = data[:3], data[3:]
        w = 0
        for k, c in enumerate(chunk):
            w |= c << (7 * k)
        words.append(w)
    return words
