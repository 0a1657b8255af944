"""Modem models: burst-mode modulate/demodulate pipelines, in PyTorch.

Port of ``grtpu.digital.modems``.  Analogs of the gr-digital python modem
layer:
  * gmsk.py:108-120 (mod: NRZ syms -> gaussian interp FIR -> FM) and
    :227-245 (demod: quadrature_demod -> clock_recovery_mm_ff ->
    binary_slicer),
  * generic_mod_demod.py:76-150 / :268-313 (PSK: gray map -> diff-enc ->
    chunks2symbols -> RRC; demod: matched filter -> costas -> clock sync ->
    decisions -> diff-dec -> unmap),
  * the DMR 4FSK use case (BASELINE.json config #4): dibits -> 4FSK
    frequency pulse -> FM; demod: quadrature_demod -> matched filter ->
    M&M timing -> 4-level slicer.

Each modem runs on its ``device`` (the card unless the caller names
another, e.g. ``device="cpu"``): inputs (numpy or tensors) move
there at entry, ``modulate`` returns a complex64 tensor on it, and the
demodulators return host numpy decisions, as grtpu's do.  The matched
filters are float32 Toeplitz matmuls (``ops.fir``), which refuse to run in
TF32 on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.digital import loops
from grtpu_torch.digital.constellation import fsk4_symbols, psk_constellation
from grtpu_torch.ops import dsp
from grtpu_torch.ops.fir import batch_fir_filter, fir_filter, interp_fir_filter
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import constant, resolve


def _bits_msb(data: np.ndarray, k: int = 1) -> np.ndarray:
    """bytes -> k-bit chunks, MSB first."""
    bits = np.unpackbits(np.asarray(data, np.uint8))
    if k == 1:
        return bits
    return bits.reshape(-1, k) @ (1 << np.arange(k - 1, -1, -1))


def _to(x, device, dtype) -> torch.Tensor:
    """numpy array or tensor -> tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _zpad(x: torch.Tensor, before: int, after: int = 0) -> torch.Tensor:
    """Zero-pad the first axis."""
    return torch.cat([x.new_zeros((before,) + x.shape[1:]), x,
                      x.new_zeros((after,) + x.shape[1:])])


def median_lastdim(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, keepdim, with ``jnp.median``'s
    semantics: for an even count the mean of the two middle values,
    computed as (lo + hi) * 0.5 (``torch.median`` returns the lower one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    lo, hi = (n - 1) // 2, n // 2
    return ((s[..., lo] + s[..., hi]) * 0.5).unsqueeze(-1)


class _Modem:
    """Shared helpers: device copies of the host constants, and the
    timing-recovery stage of the three demods."""

    def _on(self, name: str, device) -> torch.Tensor:
        """The host numpy constant ``self.<name>`` as a tensor on ``device``,
        copied once per device: a call moves no constants to the card (a
        pageable host-to-device copy stalls the host until the card has
        drained its queue)."""
        return constant(self, name, device)

    def _mm(self, x, mm_state, omega_relative_limit, chunk=64):
        """Windowed (or chunked) M&M over a burst with W=32 zero history
        and L zero lookahead, trimmed to the burst's symbol count."""
        W = 32
        L = self.sps + 2 * W + loops.NTAPS
        t_eff = max((x.shape[0] - loops.NTAPS) // self.sps, 1)
        xw = _zpad(x, W, L)
        if self.chunked:
            ys, _ = loops._mm_chunked(xw, mm_state, self.sps, self.gain_omega,
                                      self.gain_mu, omega_relative_limit, W,
                                      chunk)
            t_eff = min(t_eff, int(ys.shape[0]))
        else:
            ys, _ = loops._mm_windowed(xw, mm_state, self.sps,
                                       self.gain_omega, self.gain_mu,
                                       omega_relative_limit, W)
        return ys[:t_eff], t_eff


class GmskModem(_Modem):
    """GMSK mod/demod (gmsk.py semantics)."""

    def __init__(self, samples_per_symbol: int = 2, bt: float = 0.35,
                 gain_mu: float = 0.175, mu: float = 0.5,
                 omega_relative_limit: float = 0.005,
                 chunked: bool = False, device=None):
        # chunked=True: chunk-batched M&M (clock_recovery_mm_ff_chunked)
        self.chunked = bool(chunked)
        self.device = resolve(device)
        sps = samples_per_symbol
        self.sps = sps
        self.bt = bt
        ntaps = 4 * sps
        gauss = firdes.gaussian(1.0, sps, bt, ntaps)
        sqwave = np.ones(sps, np.float32) / 1.0
        self.taps = np.convolve(gauss, sqwave).astype(np.float32)
        self.sensitivity = (np.pi / 2.0) / sps
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu
        self.mu0 = mu
        self.omega_limit = omega_relative_limit
        # receive channel filter: pass the GMSK main lobe (~(1+bt)/2T),
        # reject out-of-band noise before the discriminator
        self.rx_lpf = firdes.low_pass(1.0, 1.0, 0.5 * (1 + bt) / sps,
                                      0.25 / sps)

    def _mod_fn(self, nrz):
        # interp FIR with gaussian*rect taps, then FM at pi/2 per symbol
        kp = -(-len(self.taps) // self.sps)
        shaped = interp_fir_filter(_zpad(nrz, kp - 1),
                                   self._on("taps", nrz.device), self.sps)
        y, _ = dsp.frequency_modulator(shaped, 0.0, self.sensitivity)
        return y

    def modulate(self, data_bits: np.ndarray) -> torch.Tensor:
        """bits (0/1) -> complex baseband at sps samples/bit."""
        nrz = np.asarray(data_bits, np.float32) * 2 - 1
        return self._mod_fn(_to(nrz, self.device, torch.float32))

    def _demod_fn(self, x, mm_state):
        xf = fir_filter(_zpad(x, len(self.rx_lpf) - 1),
                        self._on("rx_lpf", x.device), 1)
        fm = dsp.quadrature_demod(_zpad(xf, 1), 1.0)
        return self._mm(fm, mm_state, self.omega_limit)

    def demodulate(self, x) -> np.ndarray:
        """complex baseband -> recovered bits."""
        st = loops.mm_windowed_init_state(float(self.sps), self.mu0,
                                          device=self.device)
        ys, n_valid = self._demod_fn(_to(x, self.device, torch.complex64), st)
        return (ys[:n_valid].cpu().numpy() > 0).astype(np.uint8)


class PskModem(_Modem):
    """Differential M-PSK burst modem (generic_mod_demod.py semantics,
    costas+M&M receiver)."""

    def __init__(self, m: int = 2, samples_per_symbol: int = 4,
                 excess_bw: float = 0.35, costas_bw: float = 0.062,
                 gain_mu: float = 0.175, differential: bool = True,
                 chunked: bool = False, device=None):
        self.chunked = bool(chunked)
        self.device = resolve(device)
        self.m = m
        self.k = int(np.log2(m))
        self.sps = samples_per_symbol
        self.constellation = psk_constellation(m)
        if m > 2:
            # rotate to the order-M costas lock grid: the loop's phase
            # detector nulls with points at odd multiples of pi/M (e.g.
            # QPSK on the +-45 deg diagonals)
            rot = np.exp(1j * np.pi / m).astype(np.complex64)
            self.constellation.points = (
                self.constellation.points * rot).astype(np.complex64)
        ntaps = 11 * samples_per_symbol
        self.rrc = firdes.root_raised_cosine(
            samples_per_symbol, samples_per_symbol, 1.0, excess_bw, ntaps)
        self.rrc_rx = firdes.root_raised_cosine(
            1.0, samples_per_symbol, 1.0, excess_bw, ntaps)
        self.costas_bw = costas_bw
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu
        self.differential = differential
        gray = [i ^ (i >> 1) for i in range(m)]
        self.gray_map = np.asarray(gray, np.int32)          # symbol -> gray pt
        inv = np.zeros(m, np.int32)
        for i, g in enumerate(gray):
            inv[g] = i
        self.ungray_map = inv

    def _mod_fn(self, syms):
        pts = torch.from_numpy(self.constellation.points).to(syms.device)
        g = self._on("gray_map", syms.device)[syms.long()]
        if self.differential:
            # phase-accumulate the GRAY-CODED symbol in point-index space:
            # p_k = p_{k-1} + gray(sym_k); the receiver's constant
            # rotational ambiguity then cancels in the index differences
            d, _ = loops.diff_encode(
                g.to(torch.uint8),
                torch.zeros((), dtype=torch.uint8, device=syms.device),
                self.m)
            cpx = pts[d.long()]
        else:
            cpx = pts[g]
        kp = -(-len(self.rrc) // self.sps)
        return interp_fir_filter(_zpad(cpx, kp - 1),
                                 self._on("rrc", cpx.device), self.sps)

    def modulate(self, bits: np.ndarray) -> torch.Tensor:
        bits = np.asarray(bits, np.uint8)
        syms = bits if self.k == 1 else _bits_msb(np.packbits(bits), self.k)
        return self._mod_fn(_to(syms.astype(np.uint8), self.device,
                                torch.uint8))

    def _demod_fn(self, x, mm_state, costas_state):
        # matched filter, normalized so the tx(gain=sps) x rx(unit) cascade
        # gives the loop gains their nominal unit signal scale
        mf = fir_filter(_zpad(x, len(self.rrc_rx) - 1),
                        self._on("rrc_rx", x.device), 1) / self.sps
        # costas carrier recovery at sample rate (order m)
        derot, _ = loops.costas_loop(mf, costas_state, self.costas_bw,
                                     self.m if self.m in (2, 4, 8) else 4)
        # complex path: RRC ISI + costas interplay needs the tighter chunk
        # (prediction drift must stay under half a symbol)
        return self._mm(derot, mm_state, 0.005, chunk=8)

    def demodulate(self, x) -> np.ndarray:
        mm = loops.mm_windowed_init_state(float(self.sps), 0.5,
                                          complex_mode=True,
                                          device=self.device)
        cs = loops.costas_init_state(self.device)
        ys, n_valid = self._demod_fn(_to(x, self.device, torch.complex64),
                                     mm, cs)
        # hard decisions; differential decode in POINT-INDEX space (the
        # costas lock's constant rotation cancels in the differences),
        # then ungray the differences
        dec = self.constellation.decision_maker(ys[:n_valid]).cpu().numpy()
        if self.differential:
            d = (dec - np.concatenate([[0], dec[:-1]])) % self.m
            syms = self.ungray_map[d]
        else:
            syms = self.ungray_map[dec]
        if self.k == 1:
            return syms.astype(np.uint8)
        bits = ((syms[:, None] >> np.arange(self.k - 1, -1, -1)) & 1)
        return bits.reshape(-1).astype(np.uint8)


class Fsk4Modem(_Modem):
    """DMR-style 4FSK modem (BASELINE.json config #4).

    Dibits -> frequency levels (+-1, +-3) * h/3 -> RRC pulse shaping ->
    FM.  Demod: quadrature demod -> matched RRC -> M&M timing -> 4-level
    slicer.  DMR parameters: 4800 symbols/s, 1944 Hz max deviation.
    """

    # the burst demods' eye-metric reference levels (unit max)
    eye_levels = np.array([-1.0, -1 / 3, 1 / 3, 1.0], np.float32)

    def __init__(self, samples_per_symbol: int = 10,
                 symbol_rate: float = 4800.0, deviation: float = 1944.0,
                 gain_mu: float = 0.05, chunked: bool = False, device=None):
        self.chunked = bool(chunked)
        self.device = resolve(device)
        self.sps = samples_per_symbol
        self.fs = samples_per_symbol * symbol_rate
        self.deviation = deviation
        self.levels = fsk4_symbols(1.0)  # unit max level
        ntaps = 11 * samples_per_symbol
        self.shape_taps = firdes.root_raised_cosine(
            samples_per_symbol, samples_per_symbol, 1.0, 0.2, ntaps)
        self.rx_taps = firdes.root_raised_cosine(
            1.0, samples_per_symbol, 1.0, 0.2, ntaps)
        self.sensitivity = 2 * np.pi * deviation / self.fs
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu

    def _mod_fn(self, levels):
        kp = -(-len(self.shape_taps) // self.sps)
        shaped = interp_fir_filter(_zpad(levels, kp - 1),
                                   self._on("shape_taps", levels.device),
                                   self.sps)
        y, _ = dsp.frequency_modulator(shaped, 0.0, self.sensitivity)
        return y

    def modulate(self, dibits: np.ndarray) -> torch.Tensor:
        lv = self.levels[np.asarray(dibits, np.int64)]
        return self._mod_fn(_to(lv, self.device, torch.float32))

    def _matched(self, x):
        """quadrature demod (levels back at +-1/3, +-1 after the cascade's
        gain of sps is divided out) and the matched RRC, over a burst."""
        fm = dsp.quadrature_demod(_zpad(x, 1), 1.0 / self.sensitivity)
        return fir_filter(_zpad(fm, len(self.rx_taps) - 1),
                          self._on("rx_taps", fm.device), 1) / self.sps

    def _demod_fn(self, x, mm_state):
        return self._mm(self._matched(x), mm_state, 0.005)

    def demodulate(self, x) -> np.ndarray:
        """Closed-loop (M&M) demod of a continuous stream -> dibits."""
        st = loops.mm_windowed_init_state(float(self.sps), 0.5,
                                          device=self.device)
        ys, n_valid = self._demod_fn(_to(x, self.device, torch.complex64), st)
        return self._slice(ys[:n_valid].cpu().numpy())

    @staticmethod
    def _slice(v: np.ndarray) -> np.ndarray:
        # levels nominally +-1/3, +-1 (unit max): slice at 0 and +-2/3
        sym = np.where(v > 2 / 3, 0b01,
                       np.where(v > 0, 0b00,
                                np.where(v > -2 / 3, 0b10, 0b11)))
        return sym.astype(np.uint8)

    def demodulate_burst_bank(self, x) -> np.ndarray:
        """Demodulate a BANK of bursts on the device: x (C, N) complex64 ->
        (C, n_sym) dibits.  The TDMA base-station path: every channel /
        slot in one batch of tensor ops (quad demod -> matched filter as one
        Toeplitz matmul -> vectorized eye-metric phase pick -> gather).
        Same open-loop algorithm as :meth:`demodulate_burst`."""
        v = self._burst_bank_fn(_to(x, self.device, torch.complex64))
        return self._slice(v.cpu().numpy())

    def _burst_bank_fn(self, x: torch.Tensor) -> torch.Tensor:
        """(C, N) complex64 -> (C, N // sps) pre-slicer levels."""
        C, N = x.shape
        xh = torch.cat([x.new_zeros((C, 1)), x], dim=1)
        prod = xh[:, 1:] * torch.conj(xh[:, :-1])
        fm = (1.0 / self.sensitivity) * torch.atan2(prod.imag, prod.real)
        K = len(self.rx_taps)
        fmh = torch.cat([fm.new_zeros((C, K - 1)), fm], dim=1)
        mf = batch_fir_filter(fmh, self._on("rx_taps", x.device), 1) / self.sps
        # CFO appears as a DC shift of the levels; the median is a robust
        # estimator, so a <=8k-sample subsample suffices
        stride = max(1, N // 8192)
        mf = mf - median_lastdim(mf[:, ::stride])
        sps = self.sps
        n_sym = N // sps
        s = mf[:, : n_sym * sps].reshape(C, n_sym, sps)
        levels = self._on("eye_levels", x.device)
        # sampling phase is constant over a burst: the eye metric over the
        # first <=1k symbols picks it (>=1 so a one-symbol burst still has a
        # defined metric); first minimum on ties, as jnp.argmin
        n_eye = max(1, min(n_sym - 1, 1024))
        err = (s[:, :n_eye, :, None] - levels).abs().amin(-1).mean(1)
        best = torch.argmin(err, dim=-1)                     # (C,)
        return torch.gather(s, 2, best[:, None, None].expand(C, n_sym, 1))[..., 0]

    def demodulate_burst(self, x) -> np.ndarray:
        """Open-loop burst demod: matched filter, CFO (DC) removal, then
        pick the sampling phase minimizing the 4-level eye metric over the
        WHOLE burst — no acquisition transient (the receiver a short TDMA
        slot needs; the loop-based demodulate() suits continuous streams)."""
        mf = self._matched(_to(x, self.device, torch.complex64)).cpu().numpy()
        mf = mf - np.median(mf)  # CFO appears as a DC shift of the levels
        sps = self.sps
        n_sym = len(mf) // sps
        levels = np.array([-1.0, -1 / 3, 1 / 3, 1.0])
        best = (np.inf, 0)
        for ph in range(sps):
            s = mf[ph: ph + n_sym * sps: sps][: n_sym - 1]
            err = np.abs(s[:, None] - levels[None, :]).min(axis=1).mean()
            if err < best[0]:
                best = (err, ph)
        return self._slice(mf[best[1]:: sps])


def awgn(x, snr_db: float, seed: int = 0, measure=None):
    """Complex AWGN at the given per-sample SNR (channel_model.py's noise);
    host numpy in and out (a tensor is read back first)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    p = (np.abs(x) ** 2).mean() if measure is None else measure
    n0 = p / (10 ** (snr_db / 10))
    r = np.random.RandomState(seed)
    noise = (r.randn(len(x)) + 1j * r.randn(len(x))) * np.sqrt(n0 / 2)
    return (x + noise).astype(np.complex64)
