"""Remaining general-library blocks.

Port of ``grtpu.blocks.misc``.  Analogs: gr_nlog10_ff, gr_transcendental,
gr_wavelet_ff (Daubechies DWT of the gsl pyramid), gr_burst_tagger,
gr_annotator_{1to1,alltoall}, gr_probe_density_b, gr_probe_mpsk_snr_c,
gr_bin_statistics_f, gr_ctcss_squelch_ff, standard_squelch (blks2impl),
gr_cpfsk_bc, gr_dpll_bb, gr_test (misbehaving-block fixture),
gr_histo_sink_f, gr_threshold_ff, gr_iqcomp_cc, blks2.error_rate,
blks2.selector / valve.

``DpllBB`` and ``IqComp`` are per-sample loops, run by
:func:`grtpu_torch.runtime.step_graph.step_scan` in grtpu's float32
operation order.  ``CtcssSquelch`` carries its partial Goertzel block
across chunks, where grtpu's drops it (see the class).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from grtpu_torch.ops import dsp
from grtpu_torch.ops.fir import check_no_tf32
from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.runtime.step_graph import step_scan
from grtpu_torch.utils.device import constant


def _host(x) -> np.ndarray:
    """A captured stream (a tensor on any device) as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class NLog10(Block):
    """gr_nlog10_ff: out = n*log10(x) + k."""

    def __init__(self, n: float = 10.0, k: float = 0.0, vlen: int = 1,
                 name=None):
        self.in_ports = (Port(torch.float32, vlen),)
        self.out_ports = (Port(torch.float32, vlen),)
        super().__init__(name)
        self.n, self.k = n, k

    def apply(self, state, x):
        return state, self.n * torch.log10(torch.clamp(x, min=1e-30)) + self.k


class Transcendental(Block):
    """gr_transcendental: apply a named math function elementwise."""

    _FNS = {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
            "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
            "tanh": torch.tanh, "sinh": torch.sinh, "cosh": torch.cosh}

    def __init__(self, fn_name: str, dtype=torch.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.fn = self._FNS[fn_name]

    def apply(self, state, x):
        return state, self.fn(x)


def daubechies_taps(order: int) -> np.ndarray:
    """Daubechies (extremal-phase) scaling coefficients, length ``order``
    (even, >= 2; order 2 = Haar), normalized so sum = sqrt(2) — the same
    family gsl_wavelet_daubechies exposes (gr_wavelet_ff.cc:56).

    Computed by spectral factorization rather than stored tables: the
    half-band polynomial P(y) = sum_k C(p-1+k, k) y^k (p = order/2
    vanishing moments) is mapped to z via y = (2 - z - 1/z)/4, its
    inside-unit-circle roots are paired with the p-fold zero at z = -1,
    and the minimum-phase factor is normalized.
    """
    if order % 2 or order < 2:
        raise ValueError("Daubechies order must be even and >= 2")
    p = order // 2
    if p == 1:
        return (np.array([1.0, 1.0]) / np.sqrt(2.0)).astype(np.float64)
    from math import comb
    import numpy.polynomial.polynomial as npp

    q = np.zeros(2 * p - 1)
    base = np.array([-1.0, 2.0, -1.0])          # ascending: -1 + 2z - z^2
    for k in range(p):
        c = comb(p - 1 + k, k) * 4.0 ** (p - 1 - k)
        term = np.array([c])
        for _ in range(k):
            term = npp.polymul(term, base)
        term = np.concatenate([np.zeros(p - 1 - k), term])
        q[: len(term)] += term
    roots = np.roots(q[::-1])
    keep = roots[np.abs(roots) < 1.0]
    if len(keep) != p - 1:
        raise ValueError(f"spectral factorization failed for order {order}")
    h = np.array([1.0 + 0j])
    for _ in range(p):
        h = npp.polymul(h, [0.5, 0.5])
    for r in keep:
        h = npp.polymul(h, [-r, 1.0])
    h = np.real(h)[::-1].copy()                 # extremal-phase ordering
    h *= np.sqrt(2.0) / h.sum()
    return h


def _dwt_matrix(size: int, order: int, forward: bool) -> np.ndarray:
    """The full GSL wavelet pyramid as ONE orthogonal size x size matrix.

    gsl_wavelet_transform_forward runs periodized lowpass/highpass steps
    on the leading n elements for n = size, size/2, ..., 2; each step is
    linear and orthogonal, so the whole transform composes into a single
    matrix — on TPU the per-vector DWT is then one (B, size) @ (size,
    size) MXU matmul instead of a log2(size)-deep gather pyramid.  The
    inverse transform is its transpose.
    """
    if size & (size - 1):
        raise ValueError("wavelet size must be a power of 2")
    h1 = daubechies_taps(order)
    nc = len(h1)
    # quadrature mirror: g1[k] = (-1)^k h1[nc-1-k] (gsl daubechies_init)
    g1 = ((-1.0) ** np.arange(nc)) * h1[::-1]
    W = np.eye(size)
    n = size
    while n >= 2:
        step = np.eye(size)
        nh = n // 2
        for i in range(nh):
            row_s = np.zeros(size)
            row_d = np.zeros(size)
            for k in range(nc):
                j = (2 * i + k) % n
                row_s[j] += h1[k]
                row_d[j] += g1[k]
            step[i] = row_s
            step[i + nh] = row_d
        W = step @ W
        n //= 2
    return (W if forward else W.T).astype(np.float32)


class WaveletFF(Block):
    """gr_wavelet_ff (gnuradio-core/src/lib/general/gr_wavelet_ff.cc:56):
    per-vector Daubechies DWT of the full gsl pyramid, ``order`` = wavelet
    length (even, 2..20+), ``forward=False`` for the inverse transform.

    The whole multi-level periodized transform is pre-composed into one
    orthogonal matrix (host numpy constant) and applied as one float32
    matmul (TF32 refused); see _dwt_matrix.
    """

    def __init__(self, size: int = 1024, order: int = 20,
                 forward: bool = True, name=None):
        self.in_ports = (Port(torch.float32, size),)
        self.out_ports = (Port(torch.float32, size),)
        super().__init__(name)
        self.size, self.order, self.forward = size, order, forward
        self._w = np.ascontiguousarray(
            _dwt_matrix(size, order, forward).T)   # apply as x @ Wt

    def apply(self, state, x):
        check_no_tf32(x)
        return state, x @ constant(self, "_w", x.device)


class BurstTagger(Block):
    """gr_burst_tagger: signal passthrough; the second (magnitude) input
    gates burst start/end and stream Tags ("burst", True/False) are emitted
    at the transitions (gr_burst_tagger.cc work's add_item_tag).

    Detection runs on the device (``device_tags``): transitions are found
    there and only a fixed-size (offset, active) record crosses to the
    host, so the block works under step() and run(device_loop=True) alike,
    and the carried last-active flag lives in the state."""

    emits_tags = True
    device_tags = True

    def __init__(self, threshold: float = 0.5, dtype=torch.complex64,
                 name=None):
        self.in_ports = (Port(dtype), Port(torch.float32))
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.threshold = threshold

    def init_state(self):
        return torch.zeros((), dtype=torch.bool)  # last chunk's final flag

    def apply(self, state, x, mag):
        active = mag > self.threshold
        return active[-1], x

    def apply_tagged(self, state, x, mag):
        active = mag > self.threshold
        prev = torch.cat([state.reshape(1), active[:-1]])
        offs, idx = self._tag_topk(active != prev, active.shape[0])
        rec = {"offset": offs,
               "value": torch.where(offs >= 0, active[idx], False)}
        return active[-1], x, rec

    def tags_from_device(self, rec, start_in, start_out):
        from grtpu_torch.runtime.tags import Tag

        return [Tag(start_out + int(o), "burst", bool(v), self.name)
                for o, v in zip(rec["offset"], rec["value"]) if o >= 0]


class Annotator(Block):
    """gr_annotator_1to1 / alltoall: pass-through tag-propagation probe."""

    def __init__(self, policy: str = "one_to_one", dtype=torch.float32,
                 name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.tag_propagation = policy
        super().__init__(name)

    def apply(self, state, x):
        return state, x


class ProbeDensity(Block):
    """gr_probe_density_b: IIR-averaged density of 1-bits."""

    def __init__(self, alpha: float = 0.01, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = ()
        super().__init__(name)
        self.alpha = alpha
        self.captured = None

    def init_state(self):
        # gr_probe_density_b.cc:42 — d_density starts at 1.0
        return torch.ones((), dtype=torch.float32)

    def apply(self, state, x):
        _, st = dsp.single_pole_iir(x.to(torch.float32), state, self.alpha)
        return st, ()

    def density(self):
        if self.captured is None:
            return 1.0
        x = _host(self.captured[0]).astype(np.float64)
        acc = 1.0
        for v in x:
            acc = self.alpha * v + (1 - self.alpha) * acc
        return acc


class ProbeMpskSnr(Block):
    """gr_probe_mpsk_snr_c: SNR estimate from mean/variance of |x|."""

    def __init__(self, alpha: float = 0.001, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = ()
        super().__init__(name)
        self.alpha = alpha
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def snr_db(self):
        if self.captured is None:
            return 0.0
        m = np.abs(_host(self.captured[0]))
        sig = m.mean() ** 2
        noise = m.var()
        return 10 * np.log10(max(sig, 1e-20) / max(noise, 1e-20))


class BinStatistics(Block):
    """gr_bin_statistics_f analog: per-vector max-hold / mean statistics
    across a run (spectrum-survey accumulator, polled after run)."""

    def __init__(self, vlen: int, name=None):
        self.in_ports = (Port(torch.float32, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def max_hold(self):
        return None if self.captured is None else \
            _host(self.captured[0]).max(axis=0)

    def mean(self):
        return None if self.captured is None else \
            _host(self.captured[0]).mean(axis=0)


class CtcssSquelch(Block):
    """gr_ctcss_squelch_ff: gate audio on presence of a CTCSS sub-audible
    tone (Goertzel power at the tone against the block's energy),
    block-granular gate.

    Blocks of ``block`` samples are counted from the start of the stream,
    and the partial block at the end of a chunk is carried in the state
    (its Goertzel sums, its energy, its length).  A sample is gated by the
    decision of its own block when that block completes within the
    sample's chunk, and otherwise by the decision of the last block that
    completed by the end of that chunk (closed before the first).  At chunks that are multiples of ``block`` every block
    completes in its chunk, and the output is grtpu's.  grtpu forms its
    blocks from each chunk alone and gates the ``chunk % block`` tail with
    zero, so its output depends on the chunk size, and a chunk shorter
    than ``block`` mutes everything; the port does not reproduce that.
    """

    def __init__(self, rate: float, freq: float, level: float = 0.01,
                 block: int = 1024, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        self.decim = 1
        super().__init__(name)
        self.rate, self.freq, self.level, self.block = rate, freq, level, block
        n = block
        k = freq * n / rate
        ph = 2 * np.pi * k / n * np.arange(n)
        # float64 twiddles of exp(-2j*pi*k/n*i): re = cos, im = -sin
        self._tw = np.stack([np.cos(ph), -np.sin(ph)]).astype(np.float64)

    def init_state(self):
        # (partial block: Goertzel re/im sums and energy, float64; samples
        # in it; the last decision)
        return (torch.zeros(3, dtype=torch.float64),
                torch.zeros((), dtype=torch.int64),
                torch.zeros((), dtype=torch.bool))

    def apply(self, state, x):
        acc, count, gate = state
        n, nb = x.shape[0], self.block
        dev = x.device
        j = torch.arange(n, device=dev)
        pos = count + j                     # position in the stream's blocks
        tw = constant(self, "_tw", dev)
        xd = x.to(torch.float64)
        terms = torch.stack([xd * tw[0][pos % nb], xd * tw[1][pos % nb],
                             xd * xd])                      # (3, n)
        cs = torch.cat([terms.new_zeros(3, 1), terms.cumsum(1)], 1)
        # block k of this call spans chunk indices [k*nb - count, ...)
        kmax = n // nb + 2
        k = torch.arange(kmax, device=dev)
        lo = (k * nb - count).clamp(0, n)
        hi = ((k + 1) * nb - count).clamp(0, n)
        sums = cs[:, hi] - cs[:, lo]                         # (3, kmax)
        sums = sums + torch.cat([acc[:, None],
                                 acc.new_zeros(3, kmax - 1)], 1)
        p_tone = (sums[0] ** 2 + sums[1] ** 2) / nb
        open_ = (p_tone / (sums[2] + 1e-12)) > self.level
        ndone = (count + n) // nb                            # blocks closed
        blk = pos // nb
        # a 0-d index would be read on the host: index with one element
        prev = (ndone - 1).clamp(min=0).reshape(1)
        last = torch.where(ndone > 0, open_.index_select(0, prev)[0], gate)
        g = torch.where(blk < ndone, open_[blk.clamp(max=kmax - 1)], last)
        # ndone <= kmax - 1
        new_acc = sums.index_select(1, ndone.reshape(1))[:, 0]
        return ((new_acc, (count + n) % nb, last),
                x * g.to(torch.float32))


class StandardSquelch(Block):
    """blks2impl/standard_squelch.py: voice-band vs high-band power ratio
    gates the audio (single-pole averaged)."""

    def __init__(self, audio_rate: float, threshold: float = 1.0, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        self.history = 3
        super().__init__(name)
        self.alpha = 1.0 / (0.01 * audio_rate)
        self.threshold = threshold

    def init_state(self):
        return (torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.float32))

    def apply(self, state, x):
        # crude band split: low = 3-tap smooth, high = first difference
        low = (x[:-2] + x[1:-1] + x[2:]) / 3
        high = (x[2:] - x[:-2]) / 2
        lp, st1 = dsp.single_pole_iir(low ** 2, state[0], self.alpha)
        hp, st2 = dsp.single_pole_iir(high ** 2, state[1], self.alpha)
        gate = (lp > self.threshold * hp).to(torch.float32)
        return (st1, st2), x[2:] * gate


class Cpfsk(Block):
    """gr_cpfsk_bc: continuous-phase FSK bits -> complex."""

    def __init__(self, k: float, amplitude: float = 1.0,
                 samples_per_symbol: int = 2, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.complex64),)
        self.interp = samples_per_symbol
        super().__init__(name)
        self.sps = samples_per_symbol
        self.amp = amplitude
        self.sens = np.pi * k / samples_per_symbol

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        nrz = x.to(torch.float32) * 2 - 1
        up = torch.repeat_interleave(nrz, self.sps)
        y, ph = dsp.frequency_modulator(up, state, self.sens)
        return ph, (self.amp * y).to(torch.complex64)


class DpllBB(Block):
    """gr_dpll_bb: digital PLL bit synchronizer over pulse stream.

    One sample a step (``step_scan``), in grtpu's float32 order: the
    ``phase >= period`` pick is discrete, so the outputs are grtpu's
    exactly."""

    def __init__(self, period: float, gain: float = 0.1, name=None):
        self.in_ports = (Port(torch.uint8),)
        self.out_ports = (Port(torch.uint8),)
        super().__init__(name)
        self.period, self.gain = period, gain

    def init_state(self):
        return (torch.tensor(self.period / 2, dtype=torch.float32),)

    def apply(self, state, x):
        period = float(np.float32(self.period))
        half = float(np.float32(self.period / 2))
        gain = float(np.float32(self.gain))

        def step(s, xi):
            phase = s[0] + 1.0
            fire = phase >= period
            phase = torch.where(fire, phase - period, phase)
            # pull phase toward input pulses
            phase = torch.where(xi > 0, phase - gain * (phase - half), phase)
            return (phase,), fire.to(torch.uint8)

        out = torch.empty_like(x)
        return step_scan(step, state, x, out), out


class GrTest(Block):
    """gr_test-style misbehaving-block fixture: configurable wrong output
    counts / NaN injection for executor robustness tests."""

    def __init__(self, produce_extra: int = 0, inject_nan: bool = False,
                 name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)
        self.produce_extra = produce_extra
        self.inject_nan = inject_nan

    def apply(self, state, x):
        y = x
        if self.inject_nan:
            y = y.clone()
            y[0] = math.nan
        if self.produce_extra:
            y = torch.cat([y, y.new_zeros(self.produce_extra)])
        return state, y


class HistoSink(Block):
    """gr_histo_sink_f: host-side histogram over the captured stream."""

    def __init__(self, nbins: int = 100, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = ()
        super().__init__(name)
        self.nbins = nbins
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def histogram(self):
        if self.captured is None:
            return None, None
        return np.histogram(_host(self.captured[0]), bins=self.nbins)


class Threshold(Block):
    """gr_threshold_ff (gr_threshold_ff.cc:47-58 basic form): hysteresis
    comparator — output 1 once the input exceeds `hi`, 0 once it drops
    below `lo`, holding the last state in between.

    Instead of a per-sample loop, the chunk's output is the value at each
    position's most recent crossing event — one cummax over
    `2*index + direction`."""

    in_ports = (Port(torch.float32),)
    out_ports = (Port(torch.float32),)

    def __init__(self, lo: float, hi: float, initial_state: float = 0.0,
                 name=None):
        super().__init__(name)
        self.lo, self.hi = float(lo), float(hi)
        self.initial = float(initial_state)

    def init_state(self):
        return torch.tensor(self.initial, dtype=torch.float32)

    def apply(self, state, x):
        n = x.shape[0]
        above = x > self.hi
        below = x < self.lo
        event = above | below
        idx = torch.arange(n, dtype=torch.int32, device=x.device)
        # encode (position, new state) as one monotone key; parity = state
        key = torch.where(event, 2 * idx + above.to(torch.int32), -1)
        last = torch.cummax(key, 0).values
        out = torch.where(last >= 0, (last % 2).to(torch.float32), state)
        return out[-1], out


class IqComp(Block):
    """gr_iqcomp_cc (gr_iqcomp_cc.cc:37-61): adaptive IQ-imbalance
    compensator — i' = i - q*wq, q' = q - i*wi with LMS weight updates
    wi += mu*q'*i, wq += mu*i'*q.  As in grtpu, the corrected samples are
    emitted (the reference's work() leaves its output store commented out,
    gr_iqcomp_cc.cc:52).  One sample a step (``step_scan``)."""

    in_ports = (Port(torch.complex64),)
    out_ports = (Port(torch.complex64),)

    def __init__(self, mu: float, name=None):
        super().__init__(name)
        self.mu = float(mu)

    def init_state(self):
        return torch.zeros((2,), dtype=torch.float32)   # (wi, wq)

    def apply(self, state, x):
        mu = float(np.float32(self.mu))

        def step(s, iq):
            w = s[0]
            i, q = iq[0], iq[1]
            i_out = i - q * w[1]
            q_out = q - i * w[0]
            w = torch.stack([w[0] + mu * q_out * i, w[1] + mu * i_out * q])
            return (w,), torch.stack([i_out, q_out])

        iq = torch.view_as_real(x.contiguous())
        out = torch.empty_like(iq)
        (w,) = step_scan(step, (state,), iq, out)
        return w, torch.view_as_complex(out)


class ErrorRate(Block):
    """blks2.error_rate (grc_gnuradio/blks2/error_rate.py): sample two
    byte streams and emit the running windowed bit (BER) or symbol (SER)
    error rate as floats.

    The reference routes samples through message queues to a Python
    watcher thread maintaining a ring buffer; here the ring is the block's
    carried state and the windowed sums are one cumsum per chunk."""

    def __init__(self, type: str = "BER", win_size: int = 1000,
                 bits_per_symbol: int = 2, name=None):
        self.in_ports = (Port(torch.uint8), Port(torch.uint8))
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)
        if type not in ("BER", "SER"):
            raise ValueError("type must be 'BER' or 'SER'")
        self.type = type
        self.win = int(win_size)
        self.bps = int(bits_per_symbol)
        # popcount table for byte XOR (host constant)
        self._pop = np.array([bin(i).count("1") for i in range(256)],
                             np.float32)

    def init_state(self):
        return (torch.zeros((self.win,), dtype=torch.float32),
                torch.zeros((), dtype=torch.float32))  # (ring, seen)

    def apply(self, state, a, b):
        hist, seen = state
        if self.type == "BER":
            e = constant(self, "_pop", a.device)[(a ^ b).long()]
            denom_unit = float(self.bps)
        else:
            e = (a != b).to(torch.float32)
            denom_unit = 1.0
        n = e.shape[0]
        full = torch.cat([hist, e])
        csum = torch.cumsum(full, 0)
        # windowed error count ending at each new sample
        errs = csum[self.win:] - csum[:n]
        nsamps = torch.clamp(
            seen + 1 + torch.arange(n, dtype=torch.float32, device=a.device),
            max=float(self.win))
        out = errs / (nsamps * denom_unit)
        return ((full[-self.win:], torch.clamp(seen + n, max=float(self.win))),
                out)


class Selector(Block):
    """blks2.selector (grc_gnuradio/blks2/selector.py): route one of N
    input streams to one of M outputs; unselected outputs carry zeros and
    unselected inputs are swallowed (the reference wires them to null
    sources/sinks).  Changing indexes mid-run follows the reference's
    lock/reconnect/unlock discipline: call set_input_index/set_output_index
    inside TopBlock.lock()/unlock() (the rebuild re-plans the graph)."""

    def __init__(self, dtype, num_inputs: int, num_outputs: int,
                 input_index: int = 0, output_index: int = 0, name=None):
        self.in_ports = tuple(Port(dtype) for _ in range(num_inputs))
        self.out_ports = tuple(Port(dtype) for _ in range(num_outputs))
        super().__init__(name)
        self.input_index = int(input_index)
        self.output_index = int(output_index)

    def set_input_index(self, i: int):
        self.input_index = int(i)
        self.touch()

    def set_output_index(self, i: int):
        self.output_index = int(i)
        self.touch()

    def apply(self, state, *xs):
        sel = (xs[self.input_index] if 0 <= self.input_index < len(xs)
               else torch.zeros_like(xs[0]))
        outs = tuple(sel if j == self.output_index
                     else torch.zeros_like(xs[0])
                     for j in range(len(self.out_ports)))
        return state, outs if len(outs) > 1 else outs[0]


class Valve(Selector):
    """blks2.valve: a 1-in/1-out selector; open=True blocks the stream
    (selector.py:108-124 — an open valve routes the input to nowhere)."""

    def __init__(self, dtype, open: bool = False, name=None):
        super().__init__(dtype, 1, 1, -1 if open else 0, 0, name)

    def set_open(self, open: bool):
        self.set_input_index(-1 if open else 0)
