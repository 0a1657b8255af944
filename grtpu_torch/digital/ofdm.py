"""OFDM stack: mapper, cyclic prefix, sync, frame acquisition, frame sink.

Port of ``grtpu.digital.ofdm``.  Analogs (the dmr fork's headline
modification):
  * digital_ofdm_mapper_bcv — bits -> occupied-subcarrier symbol vectors.
  * digital_ofdm_insert_preamble / digital_ofdm_cyclic_prefixer.
  * ofdm_sync_pn.py — Schmidl&Cox-style autocorrelation timing/CFO sync
    from a repeated-half PN preamble; ofdm_sync_{ml,pnac,fixed}.py.
  * digital_ofdm_sampler — symbol-aligned FFT-window extraction.
  * digital_ofdm_frame_acquisition (lib/digital_ofdm_frame_acquisition.cc:
    122-223) — per-subcarrier channel estimate from the known preamble +
    one-tap equalization.
  * digital_ofdm_frame_sink (lib/digital_ofdm_frame_sink.cc:422-423) —
    demap; THE FORK'S FEATURE: exports the per-subcarrier channel
    estimates alongside the demodulated data (ofdm_receiver.py:44-46).

The receive chain is batched over OFDM symbols: the timing metric is one
vectorized autocorrelation, FFTs are batched ``torch.fft`` calls,
equalization is elementwise over the (nsymbols, ncarriers) grid.

Where grtpu slices with a traced start (``lax.dynamic_slice_in_dim``, which
clamps the start to ``[0, n - size]``), the port gathers
``start.clamp(0, n - size) + arange(size)``: no host read, the same clamp.
grtpu's ``lax.cond`` computes both branches here and selects with
``torch.where``, and its ``lax.scan`` over frames is a Python loop of the
same static count, so a chunk of :class:`OfdmReceiver` captures into one
CUDA graph and vmaps over a bank of channels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.utils.device import constant, resolve


class OfdmParams(NamedTuple):
    fft_len: int = 64
    cp_len: int = 16
    occupied_carriers: Tuple[int, ...] = ()  # logical indices (+-)
    mod_order: int = 4  # QPSK mapping on carriers


def default_carriers(fft_len: int = 64, occupied: int = 48) -> np.ndarray:
    """Symmetric band of occupied carriers, skipping DC (ofdm.py default
    layout: zeros_on_left + occupied_tones centered)."""
    half = occupied // 2
    neg = np.arange(-half, 0)
    pos = np.arange(1, half + 1)
    return np.concatenate([neg, pos])  # logical carrier indices


def carrier_bins(carriers: np.ndarray, fft_len: int) -> np.ndarray:
    """Logical carrier indices -> FFT bin indices."""
    return np.where(carriers < 0, carriers + fft_len, carriers).astype(np.int64)


def _expj(angle: torch.Tensor) -> torch.Tensor:
    """exp(1j * angle) for a real float32 tensor, as complex64."""
    return torch.polar(torch.ones_like(angle), angle)


def _window(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim(x, start, size)``: the start clamped to
    ``[0, len(x) - size]``, then gathered."""
    s = torch.clamp(start, 0, x.shape[0] - size)
    return x[s + torch.arange(size, device=x.device)]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a + b * c`` with one rounding, as XLA fuses it inside
    grtpu's compiled step (taken in float64, where the float32 product is
    exact)."""
    return (a.double() + b.double() * c.double()).float()


def _at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 1-D ``t`` and a 0-d index tensor, as a gather: indexing
    with a 0-d tensor reads the index on the host, which a CUDA-graph
    capture cannot hold."""
    return t.gather(0, i.reshape(1).to(torch.int64)).squeeze(0)


def _cumsum(v: torch.Tensor) -> torch.Tensor:
    """Prefix sum accumulated in double precision, rounded back to ``v``'s
    dtype: what torch's CPU ``cumsum`` does for float32 and complex64, done
    the same way on the card (whose float32 scan accumulates in float32, in
    its own order).  The sync metric's plateau and its peak index are
    discrete choices on nearly equal values; with the sums agreeing between
    devices, so do they, and so does the exported channel estimate, whose
    common phase follows the CFO read at the peak."""
    wide = torch.complex128 if v.is_complex() else torch.float64
    return torch.cumsum(v.to(wide), 0).to(v.dtype)


def _nearest(r: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Index of the nearest constellation point (first on ties)."""
    return torch.argmin((r[..., None] - pts).abs() ** 2, dim=-1)


class OfdmModem:
    """Burst OFDM modem with Schmidl&Cox sync + preamble channel estimation.

    Frame = [sync preamble (repeated-half PN) | known preamble | data syms].
    ``modulate`` builds the burst on the host (numpy, as grtpu); the
    receive side runs on ``device`` (the card unless named).
    """

    def __init__(self, fft_len: int = 64, cp_len: int = 16,
                 occupied: int = 48, mod_order: int = 4, seed: int = 17,
                 device=None):
        self.fft_len = fft_len
        self.cp_len = cp_len
        self.carriers = default_carriers(fft_len, occupied)
        self.bins = carrier_bins(self.carriers, fft_len)
        self.occupied = occupied
        self.mod_order = mod_order
        self.bits_per_sym = int(np.log2(mod_order))
        self.device = resolve(device)
        rng = np.random.RandomState(seed)
        # sync preamble: PN on even FFT bins -> time-domain symbol with two
        # identical halves (Schmidl & Cox)
        pn = (2 * rng.randint(0, 2, occupied) - 1).astype(np.float32)
        sync_freq = np.zeros(fft_len, np.complex64)
        even_mask = self.bins % 2 == 0
        sync_freq[self.bins[even_mask]] = (
            pn[even_mask] * np.sqrt(2)).astype(np.complex64)
        self.sync_time = np.fft.ifft(sync_freq).astype(np.complex64)
        # channel-estimation preamble: known QPSK on every occupied carrier
        s = 1 / np.sqrt(2)
        cpts = np.array([s * (1 + 1j), s * (-1 + 1j), s * (-1 - 1j),
                         s * (1 - 1j)], np.complex64)
        self.known_idx = rng.randint(0, 4, occupied)
        self.known = cpts[self.known_idx]
        self.qpsk = cpts

    # ----------------------------------------------------------------- mod
    def modulate(self, bits: np.ndarray) -> np.ndarray:
        """bits -> burst samples (preambles + data symbols, all CP'd), as a
        host complex64 array."""
        bits = np.asarray(bits, np.uint8)
        k = self.bits_per_sym
        per_sym = self.occupied * k
        nsym = -(-len(bits) // per_sym)
        pad = nsym * per_sym - len(bits)
        b = np.concatenate([bits, np.zeros(pad, np.uint8)])
        pts = b.reshape(nsym, self.occupied, k)
        idx = np.zeros((nsym, self.occupied), np.int64)
        for j in range(k):
            idx = (idx << 1) | pts[:, :, j]
        sym = self.qpsk[idx] if self.mod_order == 4 else \
            np.where(idx == 1, 1.0, -1.0).astype(np.complex64)
        freq = np.zeros((nsym, self.fft_len), np.complex64)
        freq[:, self.bins] = sym
        data_time = np.fft.ifft(freq, axis=1).astype(np.complex64)
        known_freq = np.zeros((1, self.fft_len), np.complex64)
        known_freq[0, self.bins] = self.known
        known_time = np.fft.ifft(known_freq, axis=1).astype(np.complex64)
        frames = np.concatenate(
            [self.sync_time[None, :], known_time, data_time], axis=0)
        cp = frames[:, -self.cp_len:]
        return np.concatenate([cp, frames], axis=1).reshape(-1)

    # --------------------------------------------------------------- sync
    def sync_metric(self, x: torch.Tensor):
        """Schmidl&Cox timing metric |P(d)|^2 / R(d)^2 (ofdm_sync_pn.py):
        P = autocorrelation at lag L/2 over a window of L/2."""
        h = self.fft_len // 2
        prod = x[h:] * torch.conj(x[:-h])
        pw = x[h:].abs() ** 2
        cs = torch.cat([prod.new_zeros(1), _cumsum(prod)])
        P = cs[h:] - cs[:-h]
        ce = torch.cat([pw.new_zeros(1), _cumsum(pw)])
        R = ce[h:] - ce[:-h]
        # gate low-energy regions: at burst edges R -> 0 faster than |P|,
        # which would send the ratio above 1 (false peaks)
        gate = R > 0.1 * torch.max(R)
        m = torch.where(gate, P.abs() ** 2 / torch.clamp(R ** 2, min=1e-12),
                        0.0)
        return m, P

    def _acquire(self, x: torch.Tensor):
        """Timing + fine CFO from the sync preamble."""
        metric, P = self.sync_metric(x)
        L, h = self.fft_len, self.fft_len // 2
        search = metric[: x.shape[0] - 3 * L]
        mx = torch.max(search)
        # S&C metric plateaus over the sync CP; take the plateau START
        # (first index within 90% of the peak) = CP start of the frame
        d = torch.argmax((search > 0.9 * mx).to(torch.uint8)).to(torch.int32)
        d_pk = torch.argmax(search)
        # fractional CFO in radians/sample from the lag-h autocorrelation
        cfo_rad = torch.angle(_at(P, d_pk)) / h
        return d, cfo_rad

    # --------------------------------------------------------------- demod
    def demodulate(self, x, nsym_data: int):
        """Burst receive: sync, CFO-correct, FFT, channel-estimate from the
        known preamble, equalize, demap.

        Returns (bits, channel_estimate, cfo_rad, start_index) — channel
        estimate exported per the fork's frame-sink extension
        (digital_ofdm_frame_sink.cc:422-423).  ``x`` (numpy or a tensor)
        moves to the modem's device.
        """
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(device=self.device, dtype=torch.complex64)
        dev = x.device
        d, cfo = self._acquire(x)
        n = x.shape[0]
        xr = x * _expj(-(cfo * torch.arange(n, dtype=torch.float32, device=dev)))
        # d = frame CP start; symbol i's FFT window nominally begins at
        # d + cp + i*sym_len; back off half a CP so timing error stays
        # ISI-free (the residual circular shift is a per-bin phase ramp
        # common to all symbols, absorbed by the channel estimate)
        sym_len = self.fft_len + self.cp_len
        start = d + self.cp_len - self.cp_len // 2
        nsym_total = nsym_data + 2
        wins = torch.stack([_window(xr, start + i * sym_len, self.fft_len)
                            for i in range(nsym_total)])
        F = torch.fft.fft(wins, dim=1)
        occ = F[:, constant(self, "bins", dev)]
        chan = occ[1] / constant(self, "known", dev)
        data = occ[2:] / torch.clamp(chan.abs(), min=1e-9) / _expj(
            torch.angle(chan))
        # residual-CFO tracking: per-symbol decision-directed common-phase
        # loop (the frame sink's phase tracking)
        pts = constant(self, "qpsk", dev)
        phase = torch.zeros((), dtype=torch.float32, device=dev)
        rows = []
        for row in data:
            r = row * _expj(-phase)
            ref = pts[_nearest(r, pts)]
            err = torch.angle(torch.sum(r * torch.conj(ref)))
            phase = phase + err
            rows.append(r * _expj(-err))
        data = torch.stack(rows)
        # demap QPSK (gray-free direct 2-bit mapping as in modulate)
        idx = _nearest(data, pts)
        bits = torch.stack([(idx >> 1) & 1, idx & 1], dim=-1)
        return bits.reshape(-1).to(torch.uint8), chan, cfo, d


def ofdm_frame_acquisition(symbols: torch.Tensor, known: torch.Tensor,
                           bins: np.ndarray):
    """Standalone analog of digital_ofdm_frame_acquisition: given FFT'd
    symbol vectors (first = known preamble), estimate per-carrier channel
    and equalize the rest.  Returns (equalized, channel_estimate)."""
    occ = symbols[:, torch.as_tensor(np.asarray(bins), device=symbols.device)]
    chan = occ[0] / known
    eq = occ[1:] * torch.conj(chan) / torch.clamp(chan.abs() ** 2, min=1e-12)
    return eq, chan


# ---------------------------------------------------------------------------
# Sync variants (gr-digital/python/ofdm_sync_{pn,ml,pnac,fixed}.py,
# selected by ofdm_receiver.py:107-121).  Each returns per-sample timing
# metric + CFO information, fully vectorized (moving sums are cumsum
# differences; cross-correlation is one FIR).  Each runs where its input
# lies.
# ---------------------------------------------------------------------------
def _msum(v: torch.Tensor, w: int) -> torch.Tensor:
    c = torch.cat([v.new_zeros(1), _cumsum(v)])
    return c[w:] - c[:-w]


def ofdm_sync_pn(x: torch.Tensor, fft_len: int):
    """Schmidl & Cox (ofdm_sync_pn.py): lag-L/2 autocorrelation metric.

    Returns (metric, P) with metric[d] = |P(d)|^2 / R(d)^2; CFO in
    radians/sample = angle(P[peak]) / (L/2)."""
    h = fft_len // 2
    prod = x[h:] * torch.conj(x[:-h])
    pw = x.abs() ** 2
    cs = torch.cat([prod.new_zeros(1), _cumsum(prod)])
    P = cs[h:] - cs[:-h]
    ce = torch.cat([pw.new_zeros(1), _cumsum(pw)])
    R2 = ce[2 * h:] - ce[h:-h]          # second-half energy
    R1 = ce[h:-h] - ce[:-2 * h]         # first-half energy
    n = min(P.shape[0], R2.shape[0])
    P, R1, R2 = P[:n], R1[:n], R2[:n]
    # SYMMETRIC normalization (grtpu's): |P| <= sqrt(R1*R2) <= (R1+R2)/2,
    # so the metric is bounded by 1 everywhere; the reference's |P|^2/R2^2
    # blows up at a signal->silence trailing edge
    Rs = 0.5 * (R1 + R2)
    gate = Rs > 0.1 * torch.max(Rs)
    m = torch.where(gate, P.abs() ** 2 / torch.clamp(Rs ** 2, min=1e-12), 0.0)
    return m, P


def ofdm_sync_ml(x: torch.Tensor, fft_len: int, cp_len: int,
                 snr_db: float = 10.0):
    """van de Beek ML estimator (ofdm_sync_ml.py): cyclic-prefix
    correlation gamma(d) = sum_{m<cp} x[d+m] conj(x[d+m+L]), energy term
    Phi(d) = rho/2 * sum(|x[d+m]|^2 + |x[d+m+L]|^2); metric =
    |gamma| - Phi.  The metric peaks at each symbol's CP start; CFO in
    radians/sample = -angle(gamma[peak]) / L.

    Returns (metric, gamma): metric[d] for window starting at d."""
    L = fft_len
    snr = 10.0 ** (snr_db / 10.0)
    rho = snr / (snr + 1.0)
    prod = torch.conj(x[L:]) * x[:-L]          # x[d] conj(x[d+L]) per d
    pw = x[:-L].abs() ** 2 + x[L:].abs() ** 2
    gamma = _msum(prod, cp_len)
    phi = (rho / 2.0) * _msum(pw, cp_len)
    return gamma.abs() - phi, gamma


def ofdm_sync_pnac(x: torch.Tensor, fft_len: int, kstime: np.ndarray):
    """Tufvesson PN-correlation sync (ofdm_sync_pnac.py): cross-correlate
    with the known first preamble half, then delay-L/2 self-correlation of
    the correlator output — the repeated halves give two cross-correlation
    peaks L/2 apart, so their product peaks sharply at the preamble end.

    The metric peaks at d = preamble CP end + L/2 - 1.  As in grtpu, the
    product metric is energy-gated (scale-free) in place of the
    reference's raw |corr|^2 - movsum comparison.  Returns (metric, corr);
    CFO = angle(corr[peak]) / (L/2)."""
    from grtpu_torch.ops.fir import fir_filter

    h = fft_len // 2
    ks = np.conj(np.asarray(kstime)[:h])     # first half, conjugated
    taps = ks[::-1].astype(np.complex64)     # matched filter
    # correlation ending at sample d: fir with K-1 leading history
    xh = torch.cat([x.new_zeros(h - 1), x])
    cc = fir_filter(xh, taps)
    corr = cc[h:] * torch.conj(cc[:-h])
    mag2 = cc.abs() ** 2
    power = _msum(mag2, fft_len)[: corr.shape[0]]
    a = corr.abs()[: power.shape[0]]
    m = torch.where(power > 0.1 * torch.max(power), a, 0.0)
    return m, corr


def ofdm_sync_fixed(n: int, fft_len: int, cp_len: int, nsymbols: int,
                    freq_offset: float = 0.0, device=None):
    """ofdm_sync_fixed.py: no estimation — a fixed trigger at the end of
    the first symbol of each packet and a constant frequency offset.
    Returns (peaks uint8 (n,), freq float32 (n,)) on ``device`` (the card
    unless named)."""
    dev = resolve(device)
    sym_len = fft_len + cp_len
    pkt = nsymbols * sym_len
    idx = torch.arange(n, device=dev)
    peaks = ((idx % pkt) == (sym_len - 1)).to(torch.uint8)
    freq = torch.full((n,), np.pi * freq_offset, dtype=torch.float32,
                      device=dev)
    return peaks, freq


def suffix_max(met: torch.Tensor):
    """(max(met[i:]), the leftmost index of that max) for every i: grtpu's
    reverse associative scan whose combine keeps the left operand on ties.

    The values are a flipped ``cummax``.  The index is written out rather
    than taken from ``cummax``, which does not promise which of equal
    values it returns: i is a record from the right when met[i] >= every
    later value (ties included), and the leftmost argmax of met[i:] is the
    first record at or after i (a flipped ``cummin`` over record
    indices)."""
    n = met.shape[-1]
    sm = torch.flip(torch.cummax(torch.flip(met, [-1]), -1).values, [-1])
    later = torch.cat([sm[..., 1:], torch.full_like(sm[..., :1], -np.inf)],
                      -1)
    idx = torch.arange(n, dtype=torch.int32, device=met.device)
    rec = torch.where(met >= later, idx, n)
    arg = torch.flip(torch.cummin(torch.flip(rec, [-1]), -1).values, [-1])
    return sm, arg


class OfdmReceiver(Block):
    """Streaming OFDM receiver with the fork's 3-output shape
    (ofdm_receiver.py:44-46: data symbols, timing flag, channel estimates).

    A variable-rate graph block: consumes the sample stream, acquires
    frames with the selected sync variant ("pn" or "ml"), and emits one
    equalized occupied-carrier vector per OFDM symbol on port 0, a
    frame-start flag per symbol on port 1, and the per-subcarrier channel
    estimate (digital_ofdm_frame_sink.cc:422-423) per symbol on port 2 —
    all in lockstep.

    Frames are ``nsym_data`` data symbols after the 2 preamble symbols;
    after a full frame the receiver re-acquires (burst/TDMA semantics).
    Acquisition runs inside the per-frame loop, so any number of frames
    can start and complete within one chunk; a preamble must be readable
    in some chunk's window (the history, 3 symbols + fft, covers preambles
    up to ~3 symbols behind the fresh region).
    """

    variable_rate = True

    def __init__(self, modem: OfdmModem, nsym_data: int,
                 sync_type: str = "pn", snr_db: float = 10.0,
                 thresh: float = 0.6, name=None):
        occ = modem.occupied
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64, occ), Port(torch.uint8),
                          Port(torch.complex64, occ))
        sym_len = modem.fft_len + modem.cp_len
        # history: a sync detected near the chunk start needs the whole
        # sync+known preamble readable, plus the deferred-window span
        self.history = 3 * sym_len + modem.fft_len
        super().__init__(name)
        self.modem = modem
        self.nsym_data = int(nsym_data)
        self.sym_len = sym_len
        self.sync_type = sync_type
        self.snr_db = float(snr_db)
        self.thresh = float(thresh)

    @property
    def nominal_rate(self):
        return 1.0 / self.sym_len

    def _frame_iters(self, n_delivered: int) -> int:
        """Frame-loop iterations per chunk: at most n//span complete frames
        fit in n delivered samples, plus a resumed partial frame, a newly
        started partial frame, and one slack iteration."""
        span = (self.nsym_data + 2) * self.sym_len
        return n_delivered // span + 3

    def max_out_for(self, n_delivered: int) -> int:
        return self._frame_iters(n_delivered) * self.nsym_data

    def init_state(self):
        occ = self.modem.occupied
        return {
            "have": torch.zeros((), dtype=torch.bool),
            "anchor": torch.zeros((), dtype=torch.int32),  # next data window
            "cfo": torch.zeros((), dtype=torch.float32),
            "base": torch.zeros((), dtype=torch.int32),    # absolute index
            "chan": torch.ones((occ,), dtype=torch.complex64),
            "phase": torch.zeros((), dtype=torch.float32),
            "sym_left": torch.zeros((), dtype=torch.int32),  # data symbols left
            # accumulated CFO ramp phase at delivered index 0: keeps the
            # derotation continuous across chunk boundaries
            "cfo_phase": torch.zeros((), dtype=torch.float32),
        }

    def _metric(self, x):
        m = self.modem
        if self.sync_type == "ml":
            # ML's CP correlation fires at EVERY symbol boundary; gate it
            # with the S&C half-symmetry indicator so only the PN sync
            # symbol's CP start survives (ML: sharp timing and CFO; PN:
            # frame identity)
            met_ml, g = ofdm_sync_ml(x, m.fft_len, m.cp_len, self.snr_db)
            snr = 10.0 ** (self.snr_db / 10.0)
            rho = snr / (snr + 1.0)
            # normalize so the true peak sits at ~1.0 regardless of power
            norm = met_ml / torch.clamp(torch.max(g.abs()), min=1e-9) + rho
            met_pn, _ = ofdm_sync_pn(x, m.fft_len)
            nmin = min(norm.shape[0], met_pn.shape[0])
            met = torch.where(met_pn[:nmin] > 0.5, norm[:nmin], 0.0)
            return met, lambda d: -torch.angle(_at(g, d)) / m.fft_len
        met, P = ofdm_sync_pn(x, m.fft_len)
        return met, lambda d: torch.angle(_at(P, d)) / (m.fft_len // 2)

    def _acquire(self, c, x, met_all, suffmax, suffarg, cfo_of):
        """Acquisition when no frame is locked: the plateau search over the
        ground not yet consumed.  Both branches are computed; ``have``
        selects (grtpu's ``lax.cond``)."""
        m = self.modem
        dev = x.device
        n = x.shape[0]
        nm = met_all.shape[0]
        sym_len = self.sym_len
        # met_all[i] for i > anchor - sym_len: the suffix starting at s
        # (met is nonnegative, so masked max == suffix max; s clamps safely
        # because met_all is zeroed beyond lim)
        s = torch.clamp(c["anchor"] - sym_len + 1, 0, nm - 1)
        mx = _at(suffmax, s)
        d_pk = _at(suffarg, s)
        met_idx = torch.arange(nm, device=dev)
        d = torch.argmax(((met_idx >= s) & (met_all > 0.9 * mx))
                         .to(torch.uint8)).to(torch.int32)
        found = (mx > self.thresh) & ~c["have"]
        cfo = cfo_of(d_pk)
        xr_known = _window(x, d + sym_len + m.cp_len - m.cp_len // 2,
                           m.fft_len)
        pos = (d + sym_len).to(torch.float32) + torch.arange(
            m.fft_len, dtype=torch.float32, device=dev)
        F = torch.fft.fft(xr_known * _expj(-(cfo * pos)))
        chan = F[constant(m, "bins", dev)] / constant(m, "known", dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return {
            "have": c["have"] | found,
            "anchor": torch.where(
                found, d + 2 * sym_len + m.cp_len - m.cp_len // 2,
                c["anchor"]),
            "cfo": torch.where(found, cfo, c["cfo"]),
            "base": c["base"],
            "chan": torch.where(found, chan, c["chan"]),
            "phase": torch.where(found, zero, c["phase"]),
            "sym_left": torch.where(found, self.nsym_data, c["sym_left"]),
            "cfo_phase": torch.where(found, zero, c["cfo_phase"]),
        }

    def _frame(self, c, xp, n, pts):
        """One frame's candidate symbols from the acquired state ``c``:
        all nsym_data windows in one gather, one batched FFT, batched
        equalization, then grtpu's decision-directed common-phase tracking
        as a 2-sweep fixed point.  Returns (state, outputs, active)."""
        m = self.modem
        dev = xp.device
        nsym, sym_len, fft = self.nsym_data, self.sym_len, m.fft_len
        krow = torch.arange(nsym, dtype=torch.int32, device=dev)
        active = (c["have"] & (krow < c["sym_left"])
                  & (c["anchor"] + krow * sym_len + fft <= n))
        a0 = torch.clamp(c["anchor"], 0, n)
        wins = _window(xp, a0, nsym * sym_len).reshape(nsym, sym_len)[:, :fft]
        pos = ((a0.to(torch.float32) + (krow * sym_len)[:, None]
                .to(torch.float32))
               + torch.arange(fft, dtype=torch.float32, device=dev)[None, :])
        ramp = _expj(-_fma(c["cfo_phase"], c["cfo"], pos))
        Fv = torch.fft.fft(wins * ramp, dim=-1)
        chan = c["chan"]
        eq = Fv[:, constant(m, "bins", dev)] / torch.where(
            chan.abs() > 1e-9, chan, torch.ones_like(chan))[None, :]
        phase0 = c["phase"]
        # decision-free init: the 4th-power (QPSK) per-row common phase, as
        # per-row increments wrapped to the nearest pi/2 sector (diagonal
        # QPSK: on-constellation r^4 = -4s^4, so negate the sum)
        p4 = torch.angle(-torch.sum((eq * _expj(-phase0)) ** 4, dim=-1)) / 4.0
        d4 = p4 - torch.cat([p4.new_zeros(1), p4[:-1]])
        d4 = d4 - (np.pi / 2) * torch.round(d4 / (np.pi / 2))
        errs = torch.where(active, d4, 0.0)
        for _ in range(2):
            ph_traj = phase0 + torch.cat([errs.new_zeros(1),
                                          _cumsum(errs)[:-1]])
            r = eq * _expj(-ph_traj)[:, None]
            e_new = torch.angle(torch.sum(
                r * torch.conj(pts[_nearest(r, pts)]), dim=-1))
            errs = torch.where(active, e_new, 0.0)
        r_all = r * _expj(-errs)[:, None]
        e = active.sum().to(torch.int32)
        first = c["sym_left"] == nsym
        sym_left = c["sym_left"] - e
        upd = dict(c)
        upd["anchor"] = c["anchor"] + e * sym_len
        upd["phase"] = phase0 + torch.sum(errs)
        upd["sym_left"] = sym_left
        upd["have"] = c["have"] & (sym_left != 0)
        zeros = torch.zeros_like(r_all)
        out = (torch.where(active[:, None], r_all, zeros),
               (active & (krow == 0) & first).to(torch.uint8),
               torch.where(active[:, None], chan[None, :], zeros))
        return upd, out, active

    def apply(self, state, x):
        m = self.modem
        n = x.shape[0]
        sym_len = self.sym_len
        dev = x.device
        max_out = self.max_out_for(n)
        pts = constant(m, "qpsk", dev)

        # metric once per chunk; acquisition happens inside the frame loop
        # so a frame completing mid-chunk hands straight to the next
        # preamble
        met_all, cfo_of = self._metric(x)
        lim = n - (2 * sym_len + m.fft_len)
        nm = met_all.shape[0]
        met_all = torch.where(torch.arange(nm, device=dev) < lim, met_all, 0.0)
        suffmax, suffarg = suffix_max(met_all)

        xp = torch.cat([x, x.new_zeros(self.nsym_data * sym_len)])
        c = dict(state)
        outs, actives = [], []
        for _ in range(self._frame_iters(n)):
            c = self._acquire(c, x, met_all, suffmax, suffarg, cfo_of)
            c, out, active = self._frame(c, xp, n, pts)
            outs.append(out)
            actives.append(active)
        # flatten the frame tiles and compact the valid rows to a
        # contiguous prefix (a resumed partial frame fills only part of its
        # tile): a stable argsort on the inactive flag is an
        # order-preserving permutation
        actives = torch.cat(actives)
        order = torch.argsort((~actives).to(torch.uint8), stable=True)
        ys = tuple(torch.cat([o[j] for o in outs])[order] for j in range(3))
        n_valid = actives.sum().to(torch.int32)
        # rebase anchor against consumed fresh samples; roll the CFO ramp
        # phase forward so derotation stays continuous across the boundary
        chunk_len = n - (self.history - 1)
        c["anchor"] = c["anchor"] - chunk_len
        c["base"] = c["base"] + chunk_len
        ph = (c["cfo_phase"].double() + c["cfo"].double() * chunk_len).float()
        c["cfo_phase"] = ph - 2 * np.pi * torch.floor(ph / (2 * np.pi) + 0.5)
        assert ys[0].shape[0] == max_out
        return c, (ys, n_valid)


class OfdmPacketModem:
    """Packet layer over the OFDM burst PHY — the ofdm_mod/ofdm_demod
    contract (gr-digital/python/ofdm.py:35-305 send_pkt/callback shape,
    ofdm_packet_utils.py:84-177 framing): each frame carries
    ``header(2x(whitener_offset<<12 | body_len)) + whiten(payload+crc32)``
    padded with 0x55 to the frame's bit capacity; the receive side parses
    the header off the demapped bit stream, dewhitens, and CRC-checks
    (digital_ofdm_frame_sink.cc:1024-1051 dewhiten + crc path).

    Host-side framing glue (bytes <-> bits): the PHY work — modulate,
    acquisition, equalization, demapping — runs in the OfdmModem /
    OfdmReceiver / OfdmFrameSink path this class composes.
    """

    HDR_BYTES = 4

    def __init__(self, modem: OfdmModem, nsym_data: int):
        self.modem = modem
        self.nsym_data = int(nsym_data)
        self.frame_bits = self.nsym_data * modem.occupied * modem.bits_per_sym
        cap = self.frame_bits // 8 - self.HDR_BYTES
        self.max_payload = cap - 4          # minus crc32

    def make_burst(self, payload: bytes,
                   whitener_offset: int = 0) -> np.ndarray:
        """payload -> one OFDM burst (host complex64 samples, preambles
        included).  Raises if the payload overflows the frame."""
        from grtpu_torch.digital import packet as pu

        if len(payload) > self.max_payload:
            raise ValueError(
                f"payload {len(payload)} B > frame capacity "
                f"{self.max_payload} B ({self.nsym_data} data symbols)")
        body = pu.whiten(pu.gen_and_append_crc32(payload), whitener_offset)
        hdr = pu.make_header(len(body), whitener_offset)
        pad = self.frame_bits // 8 - self.HDR_BYTES - len(body)
        bits = pu.bytes_to_bits(hdr + body + b"\x55" * pad)
        return self.modem.modulate(bits)

    def parse_frames(self, bits, flags):
        """(bits, frame-start flags) from OfdmFrameSink + OfdmReceiver
        port 1 (tensors or numpy) -> list of (crc_ok, payload_bytes), one
        per detected frame (the callback argument pair of ofdm_demod)."""
        from grtpu_torch.digital import packet as pu

        def host(a):
            return (a.cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a)).astype(np.uint8)

        bits, flags = host(bits), host(flags)
        spb = self.modem.occupied * self.modem.bits_per_sym
        out = []
        for sym_idx in np.flatnonzero(flags):
            start = int(sym_idx) * spb
            fb = bits[start: start + self.frame_bits]
            if len(fb) < self.frame_bits:
                break                        # partial frame at stream end
            parsed = pu.parse_header(pu.bits_to_bytes(fb[: 8 * self.HDR_BYTES]))
            if parsed is None:
                out.append((False, b""))
                continue
            body_len, off = parsed
            body_bits = fb[8 * self.HDR_BYTES:
                           8 * (self.HDR_BYTES + body_len)]
            if len(body_bits) < 8 * body_len:
                out.append((False, b""))
                continue
            body = pu.dewhiten(pu.bits_to_bytes(body_bits), off)
            out.append(pu.check_crc32(body))
        return out


class OfdmFrameSink(Block):
    """digital_ofdm_frame_sink's demapping half as a fixed-rate block:
    equalized occupied-carrier vectors -> hard bits (QPSK, MSB first, the
    OfdmModem.modulate mapping).  Pairs with OfdmReceiver's port 0."""

    def __init__(self, modem: OfdmModem, name=None):
        k = modem.bits_per_sym
        self.in_ports = (Port(torch.complex64, modem.occupied),)
        self.out_ports = (Port(torch.uint8),)
        self.interp = modem.occupied * k
        super().__init__(name)
        self.modem = modem

    def apply(self, state, v):
        idx = _nearest(v, constant(self.modem, "qpsk", v.device))
        bits = torch.stack([(idx >> 1) & 1, idx & 1], dim=-1)
        return state, bits.to(torch.uint8).reshape(-1)
