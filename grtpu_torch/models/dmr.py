"""DMR (ETSI TS 102 361) burst layer over the 4FSK modem.

Port of ``grtpu.models.dmr``.  The north-star DMR use case (BASELINE.json
config #4): Fsk4Modem (RRC-shaped 4FSK at 4800 sym/s, 1944 Hz deviation) on
an explicit torch device + this burst layer (48-bit sync correlation,
264-bit burst slicing), which works on host numpy dibits.

Burst format (TDMA level 2): 264 bits = 108 payload + 48 sync (center) +
108 payload.  Standard sync patterns included (BS/MS, data/voice).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from grtpu_torch.digital.modems import Fsk4Modem

# ETSI TS 102 361-1 sync patterns (48 bits as hex)
SYNC_PATTERNS = {
    "bs_data": 0xDFF57D75DF5D,
    "bs_voice": 0x755FD7DF75F7,
    "ms_data": 0xD5D7F77FD757,
    "ms_voice": 0x7F7D5DD57DFD,
}

BURST_BITS = 264
PAYLOAD_HALF_BITS = 108
SYNC_BITS = 48


def sync_dibits(pattern: int) -> np.ndarray:
    """48-bit sync -> 24 dibits (MSB first)."""
    bits = np.array([(pattern >> (47 - i)) & 1 for i in range(48)], np.uint8)
    return ((bits[0::2] << 1) | bits[1::2]).astype(np.uint8)


def make_burst(payload_bits: np.ndarray, sync: str = "bs_data") -> np.ndarray:
    """Assemble one 264-bit burst: payload half + sync + payload half."""
    p = np.asarray(payload_bits, np.uint8)
    assert len(p) == 2 * PAYLOAD_HALF_BITS, len(p)
    bits = np.concatenate([
        p[:PAYLOAD_HALF_BITS],
        np.array([(SYNC_PATTERNS[sync] >> (47 - i)) & 1 for i in range(48)],
                 np.uint8),
        p[PAYLOAD_HALF_BITS:],
    ])
    return bits


def bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, np.uint8)
    return ((b[0::2] << 1) | b[1::2]).astype(np.uint8)


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    d = np.asarray(dibits, np.uint8)
    return np.stack([(d >> 1) & 1, d & 1], axis=1).reshape(-1)


def find_bursts(dibits: np.ndarray, sync: str = "bs_data",
                max_errors: int = 2) -> List[int]:
    """Correlate for the sync pattern in dibit space; returns burst start
    indices (dibit index of the burst's first payload dibit)."""
    pat = sync_dibits(SYNC_PATTERNS[sync]) if isinstance(sync, str) else sync
    d = np.asarray(dibits, np.int32)
    L = len(pat)
    if len(d) < L:
        return []
    # dibit mismatch count via equality correlation
    matches = np.zeros(len(d) - L + 1, np.int32)
    for j in range(L):
        matches += (d[j: j + len(matches)] == pat[j])
    hits = np.nonzero(matches >= L - max_errors)[0]
    # sync center starts at payload_half dibits into the burst
    starts = [int(h) - PAYLOAD_HALF_BITS // 2 for h in hits]
    return [s for s in starts if s >= 0]


def extract_payload(dibits: np.ndarray, burst_start: int) -> Optional[np.ndarray]:
    """216 payload bits of the burst at burst_start (dibit index)."""
    need = BURST_BITS // 2
    if burst_start + need > len(dibits):
        return None
    burst = np.asarray(dibits[burst_start: burst_start + need], np.uint8)
    bits = dibits_to_bits(burst)
    return np.concatenate([bits[:PAYLOAD_HALF_BITS],
                           bits[PAYLOAD_HALF_BITS + SYNC_BITS:]])


class DmrReceiver:
    """Complete DMR narrowband receive chain: 4FSK demod on ``device`` +
    burst layer."""

    def __init__(self, samples_per_symbol: int = 10, device=None):
        self.modem = Fsk4Modem(samples_per_symbol=samples_per_symbol,
                               device=device)

    def receive(self, samples, sync: str = "bs_data",
                max_errors: int = 4) -> List[np.ndarray]:
        dibits = self.modem.demodulate_burst(samples)
        payloads = []
        for start in find_bursts(dibits, sync, max_errors):
            p = extract_payload(dibits, start)
            if p is not None:
                payloads.append(p)
        return payloads


class DmrTransmitter:
    """4FSK burst transmitter: ``transmit`` returns a complex64 tensor on
    ``device``.  The idle dibits around the burst come from a seeded
    RandomState(7), as in grtpu."""

    def __init__(self, samples_per_symbol: int = 10, device=None):
        self.modem = Fsk4Modem(samples_per_symbol=samples_per_symbol,
                               device=device)

    def transmit(self, payload_bits: np.ndarray, sync: str = "bs_data",
                 idle_dibits: int = 48):
        bits = make_burst(payload_bits, sync)
        rng = np.random.RandomState(7)
        dibits = np.concatenate([
            rng.randint(0, 4, idle_dibits),
            bits_to_dibits(bits),
            rng.randint(0, 4, idle_dibits),
        ]).astype(np.uint8)
        return self.modem.modulate(dibits)
