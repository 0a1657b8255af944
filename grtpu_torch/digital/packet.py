"""Packet framing: CRC-32, whitening, access codes, make/unmake packet.

grtpu_torch's own copy of ``grtpu.digital.packet`` (numpy only; a test holds
the two byte for byte).  Analogs:
  * digital_crc32 (gr-digital/lib/digital_crc32.cc:131-139): CRC-32 with
    polynomial 0x04C11DB7, MSB-first (non-reflected), init 0xFFFFFFFF,
    final xor 0xFFFFFFFF — regenerated here from the polynomial instead of
    the reference's baked table.
  * gr-digital/python/packet_utils.py: packet = preamble + access code +
    header(2x (whitener_offset<<12 | payload_len)) + whitened(payload+crc)
    + trailer padding.
  * gr-digital/python/crc.py: gen_and_append_crc32 / check_crc32.

The bit-level framing runs on the host (control plane); the heavy lifting
(correlation against the access code over sample streams) is the vectorized
op in grtpu_torch.digital.correlate.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_POLY = 0x04C11DB7


def _make_table() -> np.ndarray:
    tbl = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ _POLY) & 0xFFFFFFFF if (c & 0x80000000) else (c << 1) & 0xFFFFFFFF
        tbl[i] = c
    return tbl


_TABLE = _make_table()


def update_crc32(crc: int, data: bytes) -> int:
    """digital_update_crc32 semantics (MSB-first CRC-32)."""
    crc &= 0xFFFFFFFF
    for b in bytes(data):
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(_TABLE[((crc >> 24) ^ b) & 0xFF])
    return crc


def crc32(data: bytes) -> int:
    """digital_crc32: init 0xFFFFFFFF, final xor 0xFFFFFFFF."""
    return update_crc32(0xFFFFFFFF, data) ^ 0xFFFFFFFF


def gen_and_append_crc32(payload: bytes) -> bytes:
    return bytes(payload) + struct.pack(">I", crc32(payload))


def check_crc32(data: bytes) -> Tuple[bool, bytes]:
    if len(data) < 4:
        return False, b""
    msg, tail = bytes(data[:-4]), data[-4:]
    (expected,) = struct.unpack(">I", tail)
    return crc32(msg) == expected, msg


# ------------------------------------------------------------------ whitening
def _lfsr_bytes(n: int, mask: int = 0xA9, seed: int = 0xFF, reglen: int = 8) -> np.ndarray:
    """Deterministic whitening byte sequence from a Fibonacci LFSR
    (gri_lfsr-style; the reference ships an equivalent precomputed
    random_mask table in packet_utils.py)."""
    out = np.zeros(n, np.uint8)
    reg = seed
    for i in range(n):
        b = 0
        for _ in range(8):
            bit = bin(reg & mask).count("1") & 1
            reg = ((reg << 1) | bit) & ((1 << reglen) - 1)
            b = (b << 1) | bit
        out[i] = b
    return out


_WHITENER_LEN = 4096 + 16
_WHITENER = _lfsr_bytes(_WHITENER_LEN)


def whiten(data: bytes, offset: int = 0) -> bytes:
    arr = np.frombuffer(bytes(data), np.uint8)
    return bytes((arr ^ _WHITENER[offset:offset + len(arr)]).tobytes())


dewhiten = whiten  # XOR is self-inverse


# ------------------------------------------------------------------- framing
# 64-bit default access code (packet_utils.default_access_code semantics: a
# fixed low-autocorrelation word).
DEFAULT_ACCESS_CODE_BITS = np.array(
    [1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1,
     1, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0,
     1, 1, 1, 1, 0, 0, 1, 0, 1, 0, 0, 0, 1, 1, 0, 0,
     0, 0, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0], np.uint8)
DEFAULT_PREAMBLE_BITS = np.tile(np.array([1, 0], np.uint8), 16)  # 0xAAAA...


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return bytes(np.packbits(np.asarray(bits, np.uint8)).tobytes())


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8))


def make_header(payload_len: int, whitener_offset: int = 0) -> bytes:
    """packet_utils.make_header: 16-bit value repeated twice."""
    val = ((whitener_offset & 0xF) << 12) | (payload_len & 0x0FFF)
    return struct.pack(">HH", val, val)


def parse_header(hdr: bytes) -> Optional[Tuple[int, int]]:
    v1, v2 = struct.unpack(">HH", hdr[:4])
    if v1 != v2:
        return None
    return v1 & 0x0FFF, (v1 >> 12) & 0xF


def make_packet(payload: bytes, access_code_bits: np.ndarray | None = None,
                whitener_offset: int = 0, whitening: bool = True,
                pad_for_usrp: bool = False) -> np.ndarray:
    """Build the full packet bit stream (packet_utils.make_packet):
    preamble + access code + header + whitened(payload + crc32) + trailer.

    Returns a uint8 bit array."""
    if access_code_bits is None:
        access_code_bits = DEFAULT_ACCESS_CODE_BITS
    body = gen_and_append_crc32(payload)
    if whitening:
        body = whiten(body, whitener_offset)
    hdr = make_header(len(body), whitener_offset)
    bits = np.concatenate([
        DEFAULT_PREAMBLE_BITS,
        np.asarray(access_code_bits, np.uint8),
        bytes_to_bits(hdr),
        bytes_to_bits(body),
        bytes_to_bits(b"\x55"),  # trailer
    ])
    return bits


def unmake_packet(payload_bits: np.ndarray, whitener_offset: int = 0,
                  dewhitening: bool = True) -> Tuple[bool, bytes]:
    """packet_utils.unmake_packet: payload bits (after header) -> (ok, msg)."""
    body = bits_to_bytes(payload_bits)
    if dewhitening:
        body = dewhiten(body, whitener_offset)
    return check_crc32(body)


def find_access_code(bits: np.ndarray,
                     access_code_bits: np.ndarray | None = None,
                     threshold: int = 0) -> Optional[int]:
    """Return the index just past the first access-code match within
    ``threshold`` bit errors (host-side analog of
    digital_correlate_access_code_bb; the streaming/vectorized form lives in
    grtpu_torch.digital.correlate)."""
    if access_code_bits is None:
        access_code_bits = DEFAULT_ACCESS_CODE_BITS
    code = np.asarray(access_code_bits, np.uint8)
    L = len(code)
    b = np.asarray(bits, np.uint8)
    if len(b) < L:
        return None
    # sliding mismatch count via correlation on +-1 values
    s = 2 * b.astype(np.int32) - 1
    c = 2 * code.astype(np.int32) - 1
    corr = np.correlate(s, c, mode="valid")
    errs = (L - corr) // 2
    hits = np.nonzero(errs <= threshold)[0]
    if len(hits) == 0:
        return None
    return int(hits[0]) + L
