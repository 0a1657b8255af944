"""grtpu with its rotator's phases reduced mod 2 pi before they are
rounded, for the parity tests whose ramps grtpu's float32 cannot hold.

grtpu forms ``phase + step * k`` in float32 and reduces it only by the
carried phase's wrap (``grtpu/ops/fir.py:295``, ``grtpu/ops/dsp.py:36-53``,
``grtpu/blocks/analog.py:92``): at the end of a long ramp a phase is off by
up to half a float32 step there (1e-3 rad at 1.2e4 rad, 0.03 rad at 6.4e5
rad), a fault of the reference.  ``grtpu_torch`` reduces the ramp in
float64 before it rounds (``grtpu_torch.ops.fir.phase_ramp``).  A parity
test whose ramp reaches that far holds the port to grtpu with
:func:`install` applied: grtpu's own blocks, FIRs and executor, with each
phase ``(phase + (step * k mod 2 pi)) mod 2 pi``, the offsets worked out in
float64 on the host, the carried phase grtpu's float32 (two float32
roundings a phase, 4.8e-7 rad; the carried wrap 2.4e-7 rad a chunk).
"""

import numpy as np

import jax.numpy as jnp

TWO_PI = 2 * np.pi


def _offsets(step, n):
    """float32 ``step * k mod 2 pi`` for k in [0, n), formed in float64."""
    return jnp.asarray(np.mod(float(step) * np.arange(n), TWO_PI)
                       .astype(np.float32))


def ramp(phase, step, n):
    return jnp.mod(phase + _offsets(step, n), TWO_PI)


def advance(phase, step, n):
    return jnp.mod(phase + np.float32(np.mod(float(step) * n, TWO_PI)), TWO_PI)


def install(monkeypatch):
    """Point grtpu's tuner, rotator, NCOs and signal source at the reduced
    ramp for the rest of the test."""
    from grtpu.blocks import analog, filter as filt
    from grtpu.ops import dsp, fir

    def freq_xlating_fir_filter(x, taps, phase, phase_inc, decim=1):
        y = fir.fir_filter(x, taps, decim)
        nout = y.shape[0]
        ph = ramp(phase, phase_inc * decim, nout)
        rot = jnp.exp(1j * ph).astype(jnp.complex64)
        return ((y * rot).astype(jnp.complex64),
                advance(phase, phase_inc * decim, nout))

    def rotate(x, phase, phase_inc):
        n = x.shape[0]
        y = x * jnp.exp(1j * ramp(phase, phase_inc, n)).astype(jnp.complex64)
        return (y.astype(jnp.complex64),
                advance(phase, phase_inc, n).astype(jnp.float32))

    def nco(wave):
        def f(phase, phase_inc, n):
            return wave(ramp(phase, phase_inc, n)), advance(phase, phase_inc, n)
        return f

    def sig_source_apply(self, state, n):
        inc = TWO_PI * self.freq / self.fs
        return advance(state, inc, n), _sig_source(self, ramp(state, inc, n), n)

    monkeypatch.setattr(fir, "freq_xlating_fir_filter", freq_xlating_fir_filter)
    monkeypatch.setattr(filt, "_fx", freq_xlating_fir_filter)
    monkeypatch.setattr(dsp, "rotate", rotate)
    monkeypatch.setattr(dsp, "nco_sin", nco(jnp.sin))
    monkeypatch.setattr(dsp, "nco_cos", nco(jnp.cos))
    monkeypatch.setattr(
        dsp, "nco_exp", nco(lambda p: jnp.exp(1j * p).astype(jnp.complex64)))
    monkeypatch.setattr(analog.SigSource, "apply", sig_source_apply)


def _sig_source(blk, ph, n):
    """grtpu's ``SigSource.apply`` waveforms (``grtpu/blocks/analog.py``)
    over the phases ``ph``."""
    wf, dt = blk.waveform, blk._dtype
    if jnp.issubdtype(dt, jnp.complexfloating) or wf == "complex":
        return (blk.amp * jnp.exp(1j * ph) + blk.offset).astype(jnp.complex64)
    if wf == "cos":
        return (blk.amp * jnp.cos(ph) + blk.offset).astype(dt)
    if wf == "sin":
        return (blk.amp * jnp.sin(ph) + blk.offset).astype(dt)
    if wf == "square":
        return (blk.amp * jnp.where(jnp.mod(ph, TWO_PI) < np.pi, 1.0, 0.0)
                + blk.offset).astype(dt)
    if wf == "triangle":
        frac = jnp.mod(ph, TWO_PI) / TWO_PI
        return (blk.amp * (2 * jnp.abs(2 * frac - 1) - 1) + blk.offset).astype(dt)
    if wf == "sawtooth":
        frac = jnp.mod(ph, TWO_PI) / TWO_PI
        return (blk.amp * (2 * frac - 1) + blk.offset).astype(dt)
    if wf == "const":
        return jnp.full((n,), blk.amp + blk.offset, dt)
    raise ValueError(f"unknown waveform {wf}")
