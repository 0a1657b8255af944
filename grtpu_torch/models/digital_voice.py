"""Digital voice TX/RX: GSM 06.10 vocoder over GMSK.

Reference behavior: blks2impl/digital_voice.py(.real) — 8 kS/s float audio
-> x32767 -> float_to_short -> gsm_full_rate.encode_sp (33-byte frames)
-> fake_channel_encoder_pp (pad 33 -> 70-byte air frames)
-> GMSK mod at 8 samples/symbol; RX is the mirror chain.

The reference's "fake channel coder" just resizes packets (room for a rate
1/2 code); we pad with zeros the same way.  The reference has no frame sync
at all (it relies on stream alignment); here RX optionally self-aligns by
scanning bit offsets for the GSM magic nibble (0xD) that starts every frame
— set ``align=False`` for the reference's raw behavior.

Port of ``grtpu.models.digital_voice``: the GSM coder and the GMSK modem run
on ``device`` (the card unless named); the fake channel coder and the RX
alignment search are host NumPy, as in grtpu.
"""

from __future__ import annotations

import numpy as np

import torch

from grtpu_torch.digital.modems import GmskModem
from grtpu_torch.utils.device import resolve
from grtpu_torch.vocoder import gsm

GSM_FRAME_SIZE = 33
AIR_FRAME_SIZE = 70
# Deterministic PN fill for the fake channel coder's padding bytes.
_PAD_PN = np.random.default_rng(0xD).integers(
    0, 256, AIR_FRAME_SIZE).astype(np.uint8)


def _bytes_to_bits(b):
    return np.unpackbits(np.asarray(b, np.uint8).reshape(-1))


def _bits_to_bytes(bits):
    n = len(bits) // 8 * 8
    return np.packbits(np.asarray(bits[:n], np.uint8))


class DigitalVoiceTx:
    """8 kS/s float audio in [-1, 1] -> 256 kS/s GMSK complex baseband."""

    def __init__(self, samples_per_symbol: int = 8, bt: float = 0.3,
                 device=None):
        self.device = resolve(device)
        self.modem = GmskModem(samples_per_symbol=samples_per_symbol, bt=bt,
                               device=self.device)
        self.state = gsm.gsm_init_encode_state(device=self.device)

    def __call__(self, audio: np.ndarray):
        pcm = np.clip(np.asarray(audio, np.float64) * 32767,
                      -32768, 32767).astype(np.int16)
        n = len(pcm) // 160 * 160
        self.state, frames = gsm.gsm_fr_encode(
            self.state, torch.from_numpy(pcm[:n]).to(self.device))
        frames = frames.cpu().numpy()
        # Fake channel coder: resize 33 -> 70 bytes.  Pad with a fixed PN
        # byte pattern (not the reference's zeros): both all-zeros (no
        # transitions) and pure 0xAA (spectral line at half baud) make the
        # RX M&M clock recovery slip symbols.
        air = np.empty((len(frames), AIR_FRAME_SIZE), np.uint8)
        air[:, :] = _PAD_PN[None, :]
        air[:, :GSM_FRAME_SIZE] = frames
        return self.modem.modulate(_bytes_to_bits(air))


class DigitalVoiceRx:
    """256 kS/s GMSK complex baseband -> 8 kS/s float audio."""

    def __init__(self, samples_per_symbol: int = 8, bt: float = 0.3,
                 align: bool = True, device=None):
        self.device = resolve(device)
        self.modem = GmskModem(samples_per_symbol=samples_per_symbol, bt=bt,
                               device=self.device)
        self.state = gsm.gsm_init_decode_state(device=self.device)
        self.align = align

    @staticmethod
    def _best_offset(bits):
        """Bit offset maximizing GSM-magic hits at air-frame starts."""
        frame_bits = AIR_FRAME_SIZE * 8
        best, best_hits = 0, -1
        for off in range(frame_bits):
            nf = (len(bits) - off) // frame_bits
            if nf <= 0:
                break
            starts = off + np.arange(nf) * frame_bits
            nib = (bits[starts] << 3 | bits[starts + 1] << 2
                   | bits[starts + 2] << 1 | bits[starts + 3])
            hits = int(np.sum(nib == 0xD))
            if hits > best_hits:
                best, best_hits = off, hits
        return best

    def __call__(self, iq) -> np.ndarray:
        bits = self.modem.demodulate(iq)
        off = self._best_offset(bits) if self.align else 0
        data = _bits_to_bytes(bits[off:])
        nf = len(data) // AIR_FRAME_SIZE
        air = data[: nf * AIR_FRAME_SIZE].reshape(nf, AIR_FRAME_SIZE)
        frames = air[:, :GSM_FRAME_SIZE]     # fake channel decoder: truncate
        self.state, pcm = gsm.gsm_fr_decode(
            self.state, torch.from_numpy(np.ascontiguousarray(frames)).to(
                self.device))
        return pcm.cpu().numpy().astype(np.float32) / 32767.0
