"""Trellis modulation utilities.

grtpu_torch's own copy of ``grtpu.trellis.fsm_utils`` (numpy only; a test holds the
two to identical output).

Analog of gr-trellis/src/examples/fsm_utils.py: base conversions, the
ISI-channel metric lookup generator, the CPM signal decomposition, and the
standard (dimensionality, constellation) modulation tuples used by the
trellis examples.
"""

from __future__ import annotations

import math

import numpy as np

from grtpu_torch.trellis.fsm import FSM, base2dec, dec2base

__all__ = [
    "dec2base", "base2dec", "make_isi_lookup", "make_cpm_signals",
    "pam2", "pam4", "pam8", "psk2", "psk4", "psk8", "orth2", "orth4",
    "c_channel",
]


def make_isi_lookup(mod, channel, normalize: bool = False):
    """fsm_utils.make_isi_lookup:78-96 — lookup table mapping FSM.from_isi
    output symbols (base-|constellation| words of the last len(channel)
    inputs, most recent first) to noiseless channel outputs
    sum_k constellation[s_k] * channel[k].  One-dimensional modulations
    only, like the reference.  Returns (1, lookup) modulation tuple."""
    dim, constellation = mod
    if dim != 1:
        raise ValueError("make_isi_lookup supports 1-D modulations only")
    ch = np.asarray(channel, np.float64)
    if normalize:
        ch = ch / math.sqrt(float((ch ** 2).sum()))
    C = len(constellation)
    L = len(ch)
    pts = np.asarray(constellation, np.float64)
    lookup = np.zeros(C ** L)
    for o in range(C ** L):
        ss = dec2base(o, C, L)
        lookup[o] = float((pts[ss] * ch).sum())
    return (1, list(lookup))


def make_cpm_signals(K: int, P: int, M: int, L: int, q, frac: float = 0.99):
    """fsm_utils.make_cpm_signals:110-166 — Rimoldi CPM decomposition:
    the (M^L)*P tilted-phase signals over one symbol interval, an
    orthonormal basis for them, and the dominant-energy sub-basis keeping
    `frac` of the energy.

    q: phase response samples, length L*Q (integral of the frequency
    pulse, q[-1] = 1/2).  Returns (f0, SS, S, F, Sf, Ff, N): tilt
    frequency, raw signals (columns), full/reduced coordinates and bases,
    and the reduced dimensionality N.
    """
    q = np.asarray(q, np.float64)
    Q = q.size // L
    h = K / P
    f0 = -h * (M - 1) / 2
    t = np.arange(Q) / Q
    qq = np.zeros(Q)
    for m in range(L):
        qq = qq + q[m * Q:m * Q + Q]
    w = (math.pi * h * (M - 1) * t - 2 * math.pi * h * (M - 1) * qq
         + math.pi * h * (L - 1) * (M - 1))

    X = (M ** L) * P
    PSI = np.empty((X, Q))
    for x in range(X):
        xv = dec2base(x // P, M, L) + [x % P]
        qq1 = np.zeros(Q)
        for m in range(L):
            qq1 = qq1 + xv[m] * q[m * Q:m * Q + Q]
        PSI[x] = 2 * math.pi * h * xv[-1] + 4 * math.pi * h * qq1 + w
    SS = np.exp(1j * PSI.T)                       # (Q, X) signals as columns

    # Orthonormal basis via SVD (scipy.linalg.orth equivalent).
    U, sv, _ = np.linalg.svd(SS, full_matrices=False)
    rank = int((sv > sv[0] * max(SS.shape) * np.finfo(float).eps).sum())
    F = U[:, :rank]
    S = F.conj().T @ SS                           # coordinates

    E = (np.abs(S) ** 2).sum(axis=1) / Q
    E = E / E.sum()
    order = np.argsort(-E)
    N = int(np.searchsorted(np.cumsum(E[order]), frac)) + 1
    Ff = F[:, order[:N]]
    Sf = S[order[:N]]
    return (f0, SS, S, F, Sf, Ff, N)


# --- standard modulations: (dimensionality, flat constellation list) -------
# (fsm_utils.py:177-199; psk/orth constellations are real-pair encoded.)

pam2 = (1, [-1, 1])
pam4 = (1, [-3, -1, 3, 1])          # includes Gray mapping
pam8 = (1, [-7, -5, -3, -1, 1, 3, 5, 7])

psk2 = (2, [1, 0,
            -1, 0])
psk4 = (2, [1, 0,
            0, 1,
            0, -1,
            -1, 0])
psk8 = (2, sum(([math.cos(2 * math.pi * i / 8),
                 math.sin(2 * math.pi * i / 8)] for i in range(8)), []))

# Proakis channel C, the examples' standard hard ISI test channel
# (fsm_utils.py:206; used by test_turbo_equalization*.py).
c_channel = [0.227, 0.460, 0.688, 0.460, 0.227]

orth2 = (2, [1, 0,
             0, 1])
orth4 = (4, [1, 0, 0, 0,
             0, 1, 0, 0,
             0, 0, 1, 0,
             0, 0, 0, 1])
