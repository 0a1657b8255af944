"""Generic modulator / demodulator — the generic_mod_demod.py path, in
PyTorch.

Port of ``grtpu.digital.generic_mod_demod``.  Analogs
(gr-digital/python/generic_mod_demod.py):
  * generic_mod (:76-150): bits -> gray-mapped constellation symbols ->
    (differential encode) -> RRC pulse shaping.
  * generic_demod (:268-313): agc2 -> fll_band_edge -> pfb_clock_sync ->
    constellation receiver -> (differential decode) -> unmap -> bits.

This is the reference's exact receive composition (``modems.PskModem`` is
the lighter Costas + M&M variant).  ``GenericModem`` works on bursts on its
``device`` (the card unless the caller names another); ``_demod_dev`` is a
function of tensors only, so a bank of channels runs as
``torch.func.vmap(partial(modem._demod_dev, upto=...))`` over its chunked
form.  The hier blocks run the same chain through the graph executor.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from grtpu_torch.blocks.pfb import (pfb_clock_sync_chunked,
                                    pfb_clock_sync_windowed,
                                    pfb_clock_sync_windowed_init)
from grtpu_torch.digital import loops
from grtpu_torch.digital.constellation import Constellation, psk_constellation
from grtpu_torch.digital.modems import _Modem, _to, _zpad
from grtpu_torch.ops import pfb as pfb_ops
from grtpu_torch.ops.fir import interp_fir_filter
from grtpu_torch.runtime.block import Port
from grtpu_torch.runtime.graph import HierBlock
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import resolve


def _default_constellation(constellation, m: int) -> Constellation:
    """M-PSK rotated by pi/M for M > 2 (the receiver's lock grid)."""
    if constellation is not None:
        return constellation
    constellation = psk_constellation(m)
    if m > 2:
        rot = np.exp(1j * np.pi / m).astype(np.complex64)
        constellation.points = (constellation.points * rot).astype(np.complex64)
    return constellation


def _gray_maps(m):
    gray = np.asarray([i ^ (i >> 1) for i in range(m)], np.int32)
    inv = np.zeros(m, np.int32)
    for i, g in enumerate(gray):
        inv[g] = i
    return gray, inv


class GenericModem(_Modem):
    """generic_mod + generic_demod with the reference's block chain."""

    def __init__(self, constellation: Constellation | None = None, m: int = 4,
                 samples_per_symbol: float = 4, excess_bw: float = 0.35,
                 freq_bw: float = 0.035, timing_bw: float = 0.045,
                 phase_bw: float = 0.06, nfilts: int = 32,
                 differential: bool = True, chunked: bool = False,
                 chunk: int = 64, device=None):
        """``chunked=True`` selects the chunk-batched AGC / FLL / clock sync
        / receiver (loops.agc2_chunked, fll_band_edge_chunked,
        pfb_clock_sync_chunked, constellation_receiver_chunked): the same
        loop semantics closed per chunk, far fewer ops than the per-sample
        loops."""
        self.chunked = bool(chunked)
        self.chunk = int(chunk)
        self.device = resolve(device)
        self.m = m
        self.k = int(np.log2(m))
        self.sps = samples_per_symbol
        self.constellation = _default_constellation(constellation, m)
        self.differential = differential
        self.excess_bw = excess_bw
        self.freq_bw, self.timing_bw, self.phase_bw = (freq_bw, timing_bw,
                                                       phase_bw)
        self.nfilts = nfilts
        # fractional sps is the reference contract (generic_mod_demod.py:94,
        # float sps >= 2): the modulator's RRC shaping runs as an arbitrary
        # resampler at rate sps (reference :140), the receiver's clock sync
        # on the fractional floor grid
        self._spsP, self._spsQ = loops.rationalize_sps(samples_per_symbol)
        if self._spsQ == 1:
            self.rrc = firdes.root_raised_cosine(
                int(samples_per_symbol), int(samples_per_symbol), 1.0,
                excess_bw, 11 * int(samples_per_symbol))
        else:
            # arb-resampler prototype at the bank's internal rate
            # (reference generic_mod :133-140)
            self.rrc = firdes.root_raised_cosine(
                nfilts, nfilts, 1.0, excess_bw, 11 * nfilts)
        # matched-filter bank for pfb_clock_sync at nfilts phases
        self.mf_bank = firdes.root_raised_cosine(
            nfilts, nfilts * samples_per_symbol, 1.0, excess_bw,
            int(round(11 * samples_per_symbol)) * nfilts)
        self.gray_map, self.ungray_map = _gray_maps(m)
        self.points = np.asarray(self.constellation.points, np.complex64)

    # ----------------------------------------------------------------- mod
    def modulate(self, bits: np.ndarray) -> torch.Tensor:
        """Bits (MSB first per symbol) -> complex64 samples on the device."""
        bits = np.asarray(bits, np.uint8)
        grp = bits[: len(bits) - len(bits) % self.k].reshape(-1, self.k)
        syms = (grp @ (1 << np.arange(self.k - 1, -1, -1))).astype(np.int32)
        g = self.gray_map[syms]
        p = np.cumsum(g) % self.m if self.differential else g
        return self._mod_dev(_to(self.points[p], self.device, torch.complex64))

    def _mod_dev(self, cpx: torch.Tensor) -> torch.Tensor:
        if self._spsQ == 1:
            sps = int(self.sps)
            kp = -(-len(self.rrc) // sps)
            return interp_fir_filter(_zpad(cpx, kp - 1),
                                     self._on("rrc", cpx.device), sps)
        # fractional sps: RRC pulse shaping as an arbitrary resampler at
        # rate sps (gr.pfb_arb_resampler_ccf, reference generic_mod :140);
        # self.rrc carries the gain nfilts the polyphase split divides out
        n = cpx.shape[0]
        kp = -(-len(self.rrc) // self.nfilts)
        pad_syms = (-n) % self._spsQ             # n * rate must be integral
        y = pfb_ops.arb_resample(_zpad(cpx, kp - 1, pad_syms), self.rrc,
                                 Fraction(self._spsP, self._spsQ),
                                 self.nfilts)
        # exactly floor(n * sps) samples, as the reference's accumulator
        return y[: (n * self._spsP) // self._spsQ]

    # --------------------------------------------------------------- demod
    def demodulate(self, x) -> np.ndarray:
        """agc2 -> fll_band_edge -> pfb_clock_sync -> constellation
        receiver -> diff decode -> ungray -> bits."""
        return self._demodulate(x)[0]

    def demodulate_diag(self, x):
        """demodulate + receiver diagnostics (the bert_rx probe points:
        recovered symbol samples for the SNR probe, FLL frequency for
        frequency_offset(), clock-sync rate for timing_offset(); see
        gr-digital/examples/narrowband/digital_bert_rx.py:75-97)."""
        return self._demodulate(x)

    def _agc(self, x: torch.Tensor) -> torch.Tensor:
        """gr_agc2 at rates 0.1 / 0.01, reference 1, gain 1/sps."""
        if self.chunked:
            Lc = self.chunk
            xa, _ = loops.agc2_chunked(_zpad(x, 0, (-x.shape[0]) % Lc),
                                       1.0 / self.sps, 1e-1, 1e-2, 1.0,
                                       chunk=Lc)
            return xa[: x.shape[0]]
        g = torch.full((), 1.0 / self.sps, dtype=torch.float32,
                       device=x.device)
        ys = []
        for xi in x.unbind(0):
            y = xi * g
            err = 1.0 - torch.abs(y)
            g = g + torch.where(err < 0, 1e-1, 1e-2) * err
            ys.append(y)
        return torch.stack(ys) if ys else x

    def _fll(self, xa: torch.Tensor):
        """FLL band edge behind fsz-1 zero history samples.
        Returns (y, (phase, freq))."""
        fsz = int(self.sps * 4)
        xh = _zpad(xa, fsz - 1)
        init = loops.fll_init_state(xa.device)
        if not self.chunked:
            return loops.fll_band_edge(xh, init, float(self.sps),
                                       self.excess_bw, fsz, self.freq_bw)
        xf, st = loops.fll_band_edge_chunked(
            _zpad(xh, 0, (-xa.shape[0]) % self.chunk), init, float(self.sps),
            self.excess_bw, fsz, self.freq_bw, chunk=self.chunk)
        return xf[: xa.shape[0]], st

    def _clock(self, xf: torch.Tensor):
        """pfb clock sync on the matched-filter bank, fixed-rate windowed
        form.  Returns (symbol-rate samples, (k, rate, rel))."""
        W = 32
        st = pfb_clock_sync_windowed_init(self.nfilts, device=xf.device)
        kp = -(-len(self.mf_bank) // self.nfilts)
        L = -(-self._spsP // self._spsQ) + 2 * W + kp
        t_eff = max(int((xf.shape[0] - kp) // self.sps), 1)
        xw = _zpad(xf, W, L + self._spsP)
        if self.chunked:
            # chunk 64 is the stability boundary: the err-free rate
            # prediction drifts ~beta*Lc^2/2 bank steps within a chunk
            ys, st = pfb_clock_sync_chunked(
                xw, st, self.sps, self.mf_bank, self.nfilts, self.timing_bw,
                W=W, chunk=self.chunk)
        else:
            ys, st = pfb_clock_sync_windowed(
                xw, st, self.sps, self.mf_bank, self.nfilts, self.timing_bw,
                W=W)
        return ys[:t_eff], st

    def _receiver(self, sym_samps: torch.Tensor) -> torch.Tensor:
        """Constellation receiver (phase loop + decisions), int32."""
        init = loops.costas_init_state(sym_samps.device)
        if not self.chunked:
            return loops.constellation_receiver(
                sym_samps, init, self.constellation, self.phase_bw)[0]
        # small chunk + 2 sweeps: the DD loop's alpha corrections are large
        # (~0.2), so the prediction must stay inside a decision sector
        rc, n = 8, sym_samps.shape[0]
        syms, _, _ = loops.constellation_receiver_chunked(
            _zpad(sym_samps, 0, (-n) % rc), init, self.constellation,
            self.phase_bw, chunk=rc, refine=2)
        return syms[:n]

    def _demod_dev(self, x: torch.Tensor, upto: str = "all"):
        """The receive chain on tensors, on x's device, with no host read
        (a bank of channels vmaps it in its chunked form).

        ``upto`` "agc", "fll" or "clock" stops the chain after that stage
        and returns its complex output; "all" (default) returns
        (symbol indices int32, valid count, symbol-rate samples, FLL
        frequency, clock-sync rate)."""
        xa = self._agc(x)
        if upto == "agc":
            return xa
        xf, fll_state = self._fll(xa)
        if upto == "fll":
            return xf
        sym_samps, clk_state = self._clock(xf)
        if upto == "clock":
            return sym_samps
        n_valid = torch.full((), sym_samps.shape[0], dtype=torch.int32,
                             device=x.device)
        return (self._receiver(sym_samps), n_valid, sym_samps, fll_state[1],
                clk_state[1])

    def _demodulate(self, x):
        syms, n_valid, samps, freq, rate = self._demod_dev(
            _to(x, self.device, torch.complex64))
        nv = int(n_valid)
        dec = syms[:nv].cpu().numpy().astype(np.int32)
        d = (dec - np.concatenate([[0], dec[:-1]])) % self.m \
            if self.differential else dec
        out = self.ungray_map[d]
        bits = ((out[:, None] >> np.arange(self.k - 1, -1, -1)) & 1)
        diag = {
            # derotated symbol-rate samples (bert SNR probe tap point)
            "symbols": samps[:nv].cpu().numpy().astype(np.complex64),
            # FLL loop frequency, radians/sample (freq_recov.get_frequency)
            "freq": float(freq),
            # clock-sync rate deviation, filter-bank steps/symbol
            # (time_recov.get_clock_rate)
            "clock_rate": float(rate),
        }
        return bits.reshape(-1).astype(np.uint8), diag


# ---------------------------------------------------------------------------
# Stream hier blocks: the reference's generic_mod / generic_demod are
# gr.hier_block2 chains (generic_mod_demod.py:76-150, :268-313); with
# variable-rate blocks first-class in the executor, the demod chain composes
# from ordinary graph blocks too.
# ---------------------------------------------------------------------------
class GenericModBlock(HierBlock):
    """generic_mod as a stream hier block (generic_mod_demod.py:76-150):
    packed bytes -> unpack k bits/chunk -> gray map -> differential encode
    -> chunks_to_symbols -> RRC pulse shaping at sps."""

    def __init__(self, constellation: Constellation | None = None, m: int = 4,
                 samples_per_symbol: int = 4, excess_bw: float = 0.35,
                 differential: bool = True, gray_code: bool = True,
                 name=None):
        super().__init__(name)
        from grtpu_torch.blocks.filter import InterpFirFilter
        from grtpu_torch.blocks.gengen import (ChunksToSymbols, MapBB,
                                               PackedToUnpacked)
        from grtpu_torch.digital.blocks import DiffEncoder

        k = int(np.log2(m))
        sps = int(samples_per_symbol)
        constellation = _default_constellation(constellation, m)
        rrc = firdes.root_raised_cosine(sps, sps, 1.0, excess_bw, 11 * sps)
        g = self.graph
        pin = g.add_input(Port(torch.uint8))
        pout = g.add_output(Port(torch.complex64))
        chain = [PackedToUnpacked(k)]
        if gray_code:
            chain.append(MapBB(_gray_maps(m)[0]))
        if differential:
            chain.append(DiffEncoder(m))
        chain.append(ChunksToSymbols(constellation.points,
                                     in_dtype=torch.uint8,
                                     out_dtype=torch.complex64))
        chain.append(InterpFirFilter(sps, rrc, "ccf"))
        g.connect(pin, *chain, pout)
        self.constellation = constellation


class GenericDemodBlock(HierBlock):
    """generic_demod as a stream hier block (generic_mod_demod.py:268-313):
    agc2 -> fll_band_edge -> pfb_clock_sync (variable rate) ->
    constellation_receiver -> differential decode -> ungray -> unpack to
    bits.  The executor's FIFO handles the clock sync's rate boundary."""

    def __init__(self, constellation: Constellation | None = None, m: int = 4,
                 samples_per_symbol: int = 4, excess_bw: float = 0.35,
                 freq_bw: float = 0.035, timing_bw: float = 0.045,
                 phase_bw: float = 0.06, nfilts: int = 32,
                 differential: bool = True, gray_code: bool = True,
                 name=None):
        super().__init__(name)
        from grtpu_torch.blocks.analog import Agc2
        from grtpu_torch.blocks.gengen import MapBB, UnpackKBits
        from grtpu_torch.blocks.pfb import PfbClockSync
        from grtpu_torch.digital.blocks import (ConstellationReceiver,
                                                DiffDecoder, FllBandEdge)

        k = int(np.log2(m))
        sps = int(samples_per_symbol)
        constellation = _default_constellation(constellation, m)
        mf_bank = firdes.root_raised_cosine(
            nfilts, nfilts * sps, 1.0, excess_bw, 11 * sps * nfilts)
        g = self.graph
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.uint8))
        chain = [
            Agc2(attack_rate=1e-1, decay_rate=1e-2, reference=1.0,
                 gain=1.0 / sps),
            FllBandEdge(sps, excess_bw, sps * 4, freq_bw),
            PfbClockSync(sps, timing_bw, mf_bank, nfilts=nfilts),
            ConstellationReceiver(constellation, phase_bw),
        ]
        if differential:
            chain.append(DiffDecoder(m))
        if gray_code:
            chain.append(MapBB(_gray_maps(m)[1]))
        chain.append(UnpackKBits(k))
        g.connect(pin, *chain, pout)
        self.constellation = constellation


class GmskModBlock(HierBlock):
    """gmsk.py gmsk_mod (:108-120) as a stream hier block: packed bytes ->
    NRZ symbols -> Gaussian-filtered interpolation -> frequency modulator
    at h=0.5 (sensitivity pi/2 per symbol)."""

    def __init__(self, samples_per_symbol: int = 2, bt: float = 0.35,
                 name=None):
        super().__init__(name)
        from grtpu_torch.blocks.filter import InterpFirFilter
        from grtpu_torch.digital.blocks import BytesToSyms

        sps = int(samples_per_symbol)
        gauss = firdes.gaussian(1.0, sps, bt, 4 * sps)
        g = self.graph
        pin = g.add_input(Port(torch.uint8))
        pout = g.add_output(Port(torch.complex64))
        g.connect(pin, BytesToSyms(), InterpFirFilter(sps, gauss, "fff"),
                  _F32ToC64FreqMod(sps), pout)
        self.sps = sps


class _F32ToC64FreqMod(HierBlock):
    """frequency_modulator_fc at GMSK sensitivity (pi/2)/sps."""

    def __init__(self, sps: int, name=None):
        super().__init__(name)
        from grtpu_torch.blocks.analog import FrequencyModulator

        g = self.graph
        pin = g.add_input(Port(torch.float32))
        pout = g.add_output(Port(torch.complex64))
        g.connect(pin, FrequencyModulator((np.pi / 2.0) / sps), pout)


class GmskDemodBlock(HierBlock):
    """gmsk.py gmsk_demod (:227-245) as a stream hier block:
    quadrature_demod -> clock_recovery_mm_ff (variable rate) ->
    binary_slicer.  Emits one bit byte per recovered symbol."""

    def __init__(self, samples_per_symbol: int = 2, gain_mu: float = 0.175,
                 mu: float = 0.5, omega_relative_limit: float = 0.005,
                 freq_error: float = 0.0, name=None):
        super().__init__(name)
        from grtpu_torch.blocks.analog import QuadratureDemod
        from grtpu_torch.digital.blocks import BinarySlicer, ClockRecoveryMMFF

        sps = int(samples_per_symbol)
        omega = sps * (1 + freq_error)
        gain_omega = 0.25 * gain_mu * gain_mu
        g = self.graph
        pin = g.add_input(Port(torch.complex64))
        pout = g.add_output(Port(torch.uint8))
        g.connect(pin, QuadratureDemod(1.0),
                  ClockRecoveryMMFF(omega, gain_omega, mu, gain_mu,
                                    omega_relative_limit),
                  BinarySlicer(), pout)
        self.sps = sps
