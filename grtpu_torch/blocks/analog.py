"""Analog / sync-loop blocks (port of ``grtpu.blocks.analog``).

Analogs: gr_quadrature_demod_cf, gr_frequency_modulator_fc,
gr_phase_modulator_fc, gr_sig_source_X, gr_agc{,2}_{cc,ff}, gr_rms_{cf,ff},
gr_simple_squelch_cc, gr_pwr_squelch, gr_pll_{refout_cc,freqdet_cf,
carriertracking_cc}, gr_fmdet_cf, gr_probe_avg_mag_sqrd_*, gr_vco_f.

The feedback loops (AGC, PLL) are per-sample recurrences with explicit
carried state (gri_agc2_cc.h, gri_control_loop.cc:34-80).  grtpu runs them
as ``lax.scan``; here each is a loop of 0-d tensor operations on the
stream's device, in the same float32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.ops import dsp
from grtpu_torch.ops.fir import phase_advance, phase_ramp


class QuadratureDemod(Block):
    """gr_quadrature_demod_cf (general/gr_quadrature_demod_cf.cc:47-62)."""

    def __init__(self, gain: float, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.float32),)
        self.history = 2
        super().__init__(name)
        self.gain = gain

    def apply(self, state, x):
        return state, dsp.quadrature_demod(x, self.gain)


class FrequencyModulator(Block):
    """gr_frequency_modulator_fc; carried state is the phase."""

    def __init__(self, sensitivity: float, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.sensitivity = sensitivity

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        y, ph = dsp.frequency_modulator(x, state, self.sensitivity)
        return ph, y


class PhaseModulator(Block):
    """gr_phase_modulator_fc."""

    def __init__(self, sensitivity: float, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.complex64),)
        super().__init__(name)
        self.sensitivity = sensitivity

    def apply(self, state, x):
        return state, dsp.phase_modulator(x, self.sensitivity)


class SigSource(Block):
    """gr_sig_source_X: waveform generator with carried NCO phase.

    waveform: 'cos', 'sin', 'square', 'triangle', 'sawtooth', 'const',
    'complex' (complex exponential, for dtype=complex64)."""

    _WAVEFORMS = ("cos", "sin", "square", "triangle", "sawtooth", "const",
                  "complex")

    def __init__(self, sampling_freq: float, waveform: str, frequency: float,
                 amplitude: float = 1.0, offset: float = 0.0,
                 dtype=torch.float32, name=None):
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        if waveform not in self._WAVEFORMS:
            raise ValueError(f"unknown waveform {waveform}")
        self.fs = sampling_freq
        self.waveform = waveform
        self.freq = frequency
        self.amp = amplitude
        self.offset = offset
        self._dtype = self.out_ports[0].dtype

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, n: int):
        inc = 2 * np.pi * self.freq / self.fs
        ph = phase_ramp(state, inc, n, state.device)
        wf = self.waveform
        if self._dtype.is_complex or wf == "complex":
            y = self.amp * torch.complex(torch.cos(ph), torch.sin(ph)) \
                + self.offset
            y = y.to(torch.complex64)
        elif wf == "cos":
            y = self.amp * torch.cos(ph) + self.offset
        elif wf == "sin":
            y = self.amp * torch.sin(ph) + self.offset
        elif wf == "square":
            hi = torch.remainder(ph, 2 * np.pi) < np.pi
            y = self.amp * hi.to(torch.float32) + self.offset
        elif wf == "const":
            y = torch.full((n,), self.amp + self.offset, dtype=torch.float32,
                           device=state.device)
        else:
            frac = torch.remainder(ph, 2 * np.pi) / (2 * np.pi)
            if wf == "triangle":
                y = self.amp * (2 * torch.abs(2 * frac - 1) - 1) + self.offset
            else:  # sawtooth
                y = self.amp * (2 * frac - 1) + self.offset
        return phase_advance(state, inc * n, state.device), y.to(self._dtype)


class Agc(Block):
    """gr_agc_{cc,ff} (gri_agc_xx): g += rate * (reference - |out|)."""

    def __init__(self, rate: float = 1e-4, reference: float = 1.0,
                 gain: float = 1.0, max_gain: float = 0.0,
                 dtype=torch.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.rate, self.reference = rate, reference
        self.gain0, self.max_gain = gain, max_gain

    def init_state(self):
        return torch.tensor(self.gain0, dtype=torch.float32)

    def _rate(self, err):
        return self.rate

    def apply(self, state, x):
        ref, maxg = self.reference, self.max_gain
        g = state
        ys = []
        for xi in x.unbind(0):
            y = xi * g
            err = ref - torch.abs(y)
            g = g + self._rate(err) * err
            if maxg > 0:
                g = torch.clamp(g, max=maxg)
            ys.append(y)
        return g, torch.stack(ys)


class Agc2(Agc):
    """gr_agc2_{cc,ff} (gri_agc2_xx): separate attack/decay rates."""

    def __init__(self, attack_rate: float = 1e-1, decay_rate: float = 1e-2,
                 reference: float = 1.0, gain: float = 1.0,
                 max_gain: float = 0.0, dtype=torch.complex64, name=None):
        super().__init__(0.0, reference, gain, max_gain, dtype, name)
        self.attack, self.decay = attack_rate, decay_rate

    def _rate(self, err):
        return torch.where(err < 0, err.new_full((), self.attack),
                           err.new_full((), self.decay))


class FeedForwardAgc(Block):
    """gr_feedforward_agc_cc: normalize by the max magnitude over the next N
    samples (non-causal window; history supplies the lookahead)."""

    def __init__(self, nsamples: int = 128, reference: float = 1.0, name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = (Port(torch.complex64),)
        self.history = nsamples
        super().__init__(name)
        self.nsamples = nsamples
        self.reference = reference

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        wmax = torch.abs(x).unfold(0, self.nsamples, 1).amax(dim=1)
        gain = self.reference / torch.clamp(wmax, min=1e-12)
        return state, (x[:n] * gain).to(torch.complex64)


def _avg_power(x: torch.Tensor, state, alpha: float):
    """Single-pole-averaged |x|^2: (avg, new_state)."""
    p = (torch.abs(x) ** 2).to(torch.float32)
    return dsp.single_pole_iir(p, state, alpha)


class Rms(Block):
    """gr_rms_{cf,ff}: single-pole-averaged RMS."""

    def __init__(self, alpha: float = 1e-4, dtype=torch.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)
        self.alpha = alpha

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        avg, st = _avg_power(x, state, self.alpha)
        return st, torch.sqrt(avg)


class ProbeAvgMagSqrd(Block):
    """gr_probe_avg_mag_sqrd_c: IIR-averaged |x|^2 with threshold flag,
    readable from the host after a run."""

    def __init__(self, threshold_db: float = 0.0, alpha: float = 1e-4,
                 name=None):
        self.in_ports = (Port(torch.complex64),)
        self.out_ports = ()
        super().__init__(name)
        self.alpha = alpha
        self.threshold = 10 ** (threshold_db / 10)
        self.captured = None

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        _, st = _avg_power(x, state, self.alpha)
        return st, ()

    def unmuted(self):
        return self.level() >= self.threshold

    def level(self):
        if self.captured is None:
            return 0.0
        x = self.captured[0].cpu().numpy()
        # re-derive the final average on host
        p = np.abs(x) ** 2
        acc = 0.0
        for v in p[-4096:]:
            acc = self.alpha * v + (1 - self.alpha) * acc
        return float(acc)


class PwrSquelch(Block):
    """gr_pwr_squelch_{cc,ff} (no ramp: gate on averaged power)."""

    def __init__(self, threshold_db: float = -40.0, alpha: float = 1e-4,
                 dtype=torch.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.alpha = alpha
        self.threshold = 10 ** (threshold_db / 10)

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        avg, st = _avg_power(x, state, self.alpha)
        return st, torch.where(avg >= self.threshold, x, torch.zeros_like(x))


class SimpleSquelch(PwrSquelch):
    """gr_simple_squelch_cc: zero output while IIR-averaged power is below
    threshold."""

    def __init__(self, threshold_db: float = -40.0, alpha: float = 1e-4,
                 name=None):
        super().__init__(threshold_db, alpha, torch.complex64, name)


class _PllBase(Block):
    """Shared 2nd-order PLL recurrence (gri_control_loop semantics)."""

    def __init__(self, loop_bw: float, max_freq: float, min_freq: float,
                 in_dtype=torch.complex64, out_dtype=torch.complex64,
                 name=None):
        self.in_ports = (Port(in_dtype),)
        self.out_ports = (Port(out_dtype),)
        super().__init__(name)
        self.alpha, self.beta = dsp.control_loop_gains(loop_bw)
        self.max_freq, self.min_freq = max_freq, min_freq

    def init_state(self):
        return (torch.zeros((), dtype=torch.float32),
                torch.zeros((), dtype=torch.float32))

    def _scan(self, state, x, emit):
        alpha, beta = self.alpha, self.beta
        fmax, fmin = self.max_freq, self.min_freq
        phase, freq = state
        ys = []
        for xi in x.unbind(0):
            ref = torch.complex(torch.cos(phase), torch.sin(phase))
            d = xi * torch.conj(ref)
            err = torch.atan2(d.imag, d.real)
            freq = torch.clamp(freq + beta * err, fmin, fmax)
            phase = dsp.phase_wrap(phase + freq + alpha * err)
            ys.append(emit(xi, ref, phase, freq))
        return (phase, freq), torch.stack(ys)


class PllRefout(_PllBase):
    """gr_pll_refout_cc: outputs the locked reference carrier."""

    def apply(self, state, x):
        return self._scan(
            state, x,
            lambda xi, ref, ph, fr: torch.complex(torch.cos(ph), torch.sin(ph)))


class PllFreqdet(_PllBase):
    """gr_pll_freqdet_cf: outputs instantaneous loop frequency (rad/sample)."""

    def __init__(self, loop_bw, max_freq, min_freq, name=None):
        super().__init__(loop_bw, max_freq, min_freq,
                         out_dtype=torch.float32, name=name)

    def apply(self, state, x):
        return self._scan(state, x, lambda xi, ref, ph, fr: fr)


class PllCarrierTracking(_PllBase):
    """gr_pll_carriertracking_cc: derotates input by the locked carrier."""

    def apply(self, state, x):
        return self._scan(state, x,
                          lambda xi, ref, ph, fr: xi * torch.conj(ref))


class FmDet(QuadratureDemod):
    """gr_fmdet_cf: balanced-discriminator FM detector (simplified to exact
    quadrature discriminator scaled to [fl, fh])."""

    def __init__(self, samplerate: float, freq_low: float, freq_high: float,
                 scl: float = 1.0, name=None):
        bw = (freq_high - freq_low) / 2 or 1.0
        super().__init__(scl * samplerate / (2 * np.pi * bw), name)


class Vco(Block):
    """gr_vco_f: out = amplitude * cos(phase), phase integrating
    sensitivity * input (gr_vco_f.cc / gr_fxpt_vco) — exact float phase
    accumulation instead of the fixed-point table."""

    in_ports = (Port(torch.float32),)
    out_ports = (Port(torch.float32),)

    def __init__(self, sampling_rate: float, sensitivity: float,
                 amplitude: float = 1.0, name=None):
        super().__init__(name)
        self.k = float(sensitivity) / float(sampling_rate)
        self.amplitude = float(amplitude)

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        y, ph = dsp.vco(x, state, self.k)
        return ph, self.amplitude * y
