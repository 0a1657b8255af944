"""BERT — bit-error-rate tester (narrowband benchmark apps), in PyTorch.

Port of ``grtpu.digital.bert``.  Analog of
gr-digital/examples/narrowband/digital_bert_tx.py and digital_bert_rx.py:

* ``BertTransmit``: an infinite stream of 1-bits through the CCSDS 7-bit
  multiplicative scrambler (mask 0x8A, seed 0x7F, len 7 —
  digital_bert_tx.py:44-46), modulated by a generic modem.
* ``BertReceive``: generic demod -> self-synchronizing descrambler ->
  BER from the IIR-averaged density of 0-bits.  One channel bit error
  makes exactly 3 descrambled errors (the scrambler polynomial has three
  taps), hence ``ber = (1 - density_of_ones) / 3``
  (digital_bert_rx.py:81-86,97).  Also the receiver diagnostics the
  reference's status thread prints: frequency offset, timing offset, and
  an SNR estimate on the recovered constellation (digital_bert_rx.py:75-95).

The tester works on bursts: ``BertTransmit.samples(nbits)`` yields one
modulated chunk (scrambler state carried across calls), and
``BertReceive.process(samples)`` demodulates a chunk and folds its bits into
the running BER estimate.  Both run on their modem's device.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.digital.generic_mod_demod import GenericModem
from grtpu_torch.digital.lfsr import Descrambler, Scrambler
from grtpu_torch.ops import dsp

CCSDS_MASK, CCSDS_SEED, CCSDS_LEN = 0x8A, 0x7F, 7


class BertTransmit:
    """bert_transmit: scrambled all-ones -> generic_mod samples."""

    def __init__(self, modem: GenericModem | None = None, **modem_kwargs):
        self.modem = modem or GenericModem(**modem_kwargs)
        self._scr = Scrambler(CCSDS_MASK, CCSDS_SEED, CCSDS_LEN)
        self._scr_state = self._scr.init_state().to(self.modem.device)

    def bits(self, nbits: int) -> np.ndarray:
        """Next nbits of the scrambled all-ones BERT sequence."""
        ones = torch.ones(nbits, dtype=torch.uint8, device=self.modem.device)
        self._scr_state, out = self._scr.apply(self._scr_state, ones)
        return out.cpu().numpy()

    def samples(self, nbits: int) -> np.ndarray:
        """Modulated samples (host complex64) for the next nbits."""
        return self.modem.modulate(self.bits(nbits)).cpu().numpy()


class BertReceive:
    """bert_receiver: generic_demod -> descrambler -> BER/SNR probes."""

    def __init__(self, modem: GenericModem | None = None,
                 alpha: float | None = None, **modem_kwargs):
        self.modem = modem or GenericModem(**modem_kwargs)
        dev = self.modem.device
        # reference: probe alpha = 1/symbol_rate; burst mode has no wall
        # clock, so default to a ~1e4-bit averaging window
        self.alpha = 1e-4 if alpha is None else alpha
        self._dsc = Descrambler(CCSDS_MASK, CCSDS_SEED, CCSDS_LEN)
        self._dsc_state = self._dsc.init_state().to(dev)
        self._density = torch.ones((), dtype=torch.float32, device=dev)
        self._diag = {"symbols": np.zeros(0, np.complex64),
                      "freq": 0.0, "clock_rate": 0.0}
        self.nbits = 0

    def process(self, samples) -> np.ndarray:
        """Demodulate one received chunk and update the probes.

        Returns the descrambled bits (all-ones when error free)."""
        bits, self._diag = self.modem.demodulate_diag(samples)
        self._dsc_state, clean = self._dsc.apply(
            self._dsc_state, torch.from_numpy(bits).to(self.modem.device))
        # gr_probe_density_b: per-bit single-pole IIR, final value kept
        _, self._density = dsp.single_pole_iir(
            clean.to(torch.float32), self._density, self.alpha)
        self.nbits += int(bits.shape[0])
        return clean.cpu().numpy()

    # ------------------------------------------------------------- probes
    def density(self) -> float:
        return float(self._density)

    def ber(self) -> float:
        """(1 - density)/3 — each channel error trips 3 descrambled bits."""
        return max(0.0, (1.0 - self.density()) / 3.0)

    def snr(self) -> float:
        """dB SNR estimate from the recovered constellation (M-PSK probe:
        mean^2/variance of |symbol|, gr_probe_mpsk_snr_c semantics)."""
        m = np.abs(self._diag["symbols"])
        if m.size < 8:
            return 0.0
        sig, noise = float(m.mean()) ** 2, float(m.var())
        return 10 * np.log10(max(sig, 1e-20) / max(noise, 1e-20))

    def frequency_offset(self, sample_rate: float = 1.0) -> float:
        """FLL-recovered CFO in Hz given the sample rate (rx.py:88-89)."""
        return self._diag["freq"] * sample_rate / (2 * np.pi)

    def timing_offset(self) -> float:
        """Clock-sync rate deviation (time_recov.get_clock_rate)."""
        return self._diag["clock_rate"]


def bert_loopback(nbits: int = 2 ** 14, m: int = 2, sps: int = 4,
                  snr_db: float | None = None, cfo: float = 0.0,
                  seed: int = 0, settle: int = 2048, device=None):
    """One-process BERT run: tx -> (awgn+cfo) -> rx.  Returns (ber, rx).

    ``settle`` bits are excluded from an additional hard bit count
    (acquisition transient; the IIR probe forgets it on its own).  The
    channel is made with numpy from ``seed``, as grtpu makes it."""
    tx = BertTransmit(m=m, samples_per_symbol=sps, device=device)
    rx = BertReceive(m=m, samples_per_symbol=sps, device=device)
    x = tx.samples(nbits)
    if cfo:
        n = np.arange(len(x))
        x = x * np.exp(2j * np.pi * cfo * n).astype(np.complex64)
    if snr_db is not None:
        r = np.random.RandomState(seed)
        p = np.mean(np.abs(x) ** 2)
        sigma = np.sqrt(p / (2 * 10 ** (snr_db / 10)))
        x = x + sigma * (r.randn(len(x)) + 1j * r.randn(len(x)))
    clean = rx.process(x.astype(np.complex64))
    tail = clean[settle:]
    hard_ber = float((tail == 0).mean() / 3.0) if tail.size else 1.0
    return hard_ber, rx
