"""Sharded multi-channel WBFM: the flagship multi-device pipeline.

Port of ``grtpu.parallel.sharded_fm``.  Maps the reference's concurrency
model (SURVEY.md §2.10) onto a 2-D ``("time", "chan")``
:class:`~grtpu_torch.parallel.mesh.Mesh`:

* ``chan`` — data parallelism over independent channels (the reference's
  manual N-pipeline fan-out, mp-sched/synthetic.py:28-45);
* ``time`` — sequence parallelism over the stream, with the overlap-save
  halo copied from the left neighbour
  (:func:`grtpu_torch.parallel.halo.ring_halo_left`).

Scalar monitoring (total audio power) is a :func:`~grtpu_torch.parallel.
mesh.psum` over the whole mesh.

IIR boundary: the FIR and demodulator history crosses time-shard
boundaries exactly through the halo.  The de-emphasis IIR is exact across
shards too: each shard solves its local first-order recurrence from a zero
incoming state (``grtpu_torch.ops.dsp.linear_recurrence``), the true
incoming states come from an exclusive prefix over the shards' affine maps
(the (a_total, y_last0) pairs gathered with
:func:`~grtpu_torch.parallel.mesh.all_gather`), and the closed-form
correction ``y += a_cumprod * y_in`` applies them (the recurrence is
linear).
"""

from __future__ import annotations

import numpy as np
import torch

from grtpu_torch.ops.dsp import linear_recurrence
from grtpu_torch.ops.fir import batch_fir_filter
from grtpu_torch.parallel.halo import ring_halo_left
from grtpu_torch.parallel.mesh import (Mesh, P, all_gather, axis_index,
                                       local_map, ppermute, psum, shard,
                                       time_chan_mesh, unshard)
from grtpu_torch.utils import firdes
from grtpu_torch.utils.device import constant


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """2-D ``("time", "chan")`` mesh of ``devices[:n_devices]`` (n logical
    shards on the card when not given); the time axis is 4 or 2 where that
    leaves at least 2 channel shards, else 1."""
    return time_chan_mesh(n_devices, devices)


class ShardedWfmBank:
    """N-channel WBFM receiver bank over a ``("time", "chan")`` mesh.

    Channels shard over ``chan``; each channel's sample stream shards over
    ``time`` with the halo copied in for all FIR and demodulator history.
    """

    def __init__(self, mesh: Mesh, quad_rate: float = 256e3,
                 audio_decim: int = 8, nchannels: int = 64):
        self.mesh = mesh
        self.quad_rate = quad_rate
        self.audio_decim = audio_decim
        self.nchannels = nchannels
        audio_rate = quad_rate / audio_decim
        self.demod_gain = quad_rate / (2 * np.pi * 75e3)
        self.audio_taps = firdes.low_pass(
            1.0, quad_rate, audio_rate / 2 - 1e3, audio_rate / 10)
        kk = float(np.tan(1.0 / (75e-6 * 2.0 * audio_rate)))
        self.deemph_p1 = (1.0 - kk) / (1.0 + kk)
        self.deemph_b0 = kk / (1.0 + kk)
        self.ntaps = int(self.audio_taps.shape[0])
        self.n_time = mesh.shape["time"]
        self.device = mesh.devices.flat[0]

    def init_state(self) -> torch.Tensor:
        """The stream state, shape (2, C): row 0 the de-emphasis IIR's y,
        row 1 the last audio input sample (the numerator's x[k-1] across
        the step boundary)."""
        return torch.zeros((2, self.nchannels), dtype=torch.float32,
                           device=self.device)

    def _local_step(self, iq, state):
        """Every shard's work, one value per mesh entry: iq (C_l, T_l)
        complex64 and state (2, C_l) in; (audio (C_l, T_l // decim), state',
        power) out."""
        m = self.mesh
        nt = m.shape["time"]
        x = ring_halo_left(iq, m, "time", self.ntaps, axis=1)

        def demod_filter(xv):
            prod = xv[:, 1:] * torch.conj(xv[:, :-1])
            fm = self.demod_gain * torch.atan2(prod.imag, prod.real)
            return batch_fir_filter(fm, constant(self, "audio_taps", xv.device),
                                    self.audio_decim)

        audio = local_map(demod_filter, m, x)
        b0, p1 = self.deemph_b0, self.deemph_p1
        last = local_map(lambda a: a[:, -1], m, audio)
        # boundary x[k-1]: the previous shard's last audio sample; shard 0
        # takes the carried last sample of the previous step
        prev = ppermute(last, m, "time", [(i, (i + 1) % nt) for i in range(nt)])
        y0 = np.empty(m.devices.shape, dtype=object)
        last0 = np.empty(m.devices.shape, dtype=object)
        a_total = np.empty(m.devices.shape, dtype=object)
        for idx in m.entries():
            if not m.is_local(idx):
                continue
            a = audio[idx]
            pc = state[idx][1] if axis_index(m, "time", idx) == 0 else prev[idx]
            u = b0 * (a + torch.cat([pc[:, None], a[:, :-1]], dim=1))
            y0[idx], last0[idx] = linear_recurrence(
                torch.full(u.shape, p1, dtype=torch.float32, device=u.device),
                u, 0.0)
            a_total[idx] = torch.full((a.shape[0],), p1 ** a.shape[1],
                                      dtype=torch.float32, device=a.device)
        all_a = all_gather(a_total, m, "time")        # (nt, C_l)
        all_b = all_gather(last0, m, "time")
        all_xlast = all_gather(last, m, "time")
        out = np.empty(m.devices.shape, dtype=object)
        new_state = np.empty(m.devices.shape, dtype=object)
        for idx in m.entries():
            if not m.is_local(idx):
                continue
            # exclusive prefix over the shards' affine maps y_out = A*y_in + B
            carried = state[idx][0]
            incoming = []
            for j in range(nt):
                incoming.append(carried)
                carried = all_a[idx][j] * carried + all_b[idx][j]
            y_in = incoming[axis_index(m, "time", idx)]
            t_l = audio[idx].shape[1]
            a_pow = p1 ** (1.0 + torch.arange(t_l, dtype=torch.float32,
                                              device=y_in.device))
            out[idx] = y0[idx] + y_in[:, None] * a_pow[None, :]
            new_state[idx] = torch.stack([carried, all_xlast[idx][nt - 1]])
        power = psum(local_map(lambda o: torch.sum(o ** 2), m, out), m,
                     ("time", "chan"))
        return out, new_state, power

    def step_fn(self):
        """The step ``(iq (C, T) complex64, state (2, C)) -> (audio (C,
        T // decim), state', power)``.  Each input is a global tensor (split
        over the mesh here) or one tensor per mesh entry, as
        :func:`grtpu_torch.parallel.multihost.feed_from_host` gives them; on
        a mesh of this process the outputs are global tensors on the mesh's
        first device, on a mesh that spans processes one tensor per local
        entry."""
        m = self.mesh

        def parts(x, spec, dtype):
            if isinstance(x, np.ndarray) and x.dtype == object:
                return x
            return shard(x, m, spec, dtype=dtype)

        def step(iq, state):
            out, st, power = self._local_step(
                parts(iq, P("chan", "time"), torch.complex64),
                parts(state, P(None, "chan"), torch.float32))
            if m.spans_processes:
                return out, st, power
            return (unshard(out, m, P("chan", "time")),
                    unshard(st, m, P(None, "chan")), power.flat[0])

        return step

    def jitted(self):
        """The port's fastest form of the step: on a mesh whose entries
        all lie on one card, the step replayed from a CUDA graph, one for
        each input shape (the first call of a shape runs eagerly, the
        second is captured, every later one replays it: inputs copied into
        static buffers, every shard's work and the copies and sums between
        them replayed, the outputs copied out).  On any other mesh it is
        :meth:`step_fn`."""
        from grtpu_torch.runtime.step_graph import StepGraph

        step = self.step_fn()
        devs = {d for d in self.mesh.devices.flat}
        if len(devs) != 1 or self.device.type != "cuda":
            return step
        graphs = {}

        def run(iq, state):
            key = (tuple(iq.shape), tuple(state.shape))
            if key not in graphs:
                bufs = {"iq": iq.to(self.device, torch.complex64).clone(),
                        "st": state.to(self.device, torch.float32).clone(),
                        "out": None}

                def body():
                    res = step(bufs["iq"], bufs["st"])
                    if bufs["out"] is None:
                        bufs["out"] = [r.clone() for r in res]
                    else:
                        for o, r in zip(bufs["out"], res):
                            o.copy_(r)

                graphs[key] = (StepGraph(body, self.device), bufs)
            else:
                bufs = graphs[key][1]
                bufs["iq"].copy_(iq)
                bufs["st"].copy_(state)
            graphs[key][0]()
            return tuple(o.clone() for o in graphs[key][1]["out"])

        return run

    def example_inputs(self, t_per_shard: int = 1024, seed: int = 0):
        """Gaussian IQ of (nchannels, n_time * t_per_shard) from ``seed``,
        and the initial state, on the mesh's first device."""
        t_total = self.n_time * t_per_shard
        g = torch.Generator().manual_seed(seed)
        r = torch.randn((self.nchannels, t_total, 2), generator=g)
        iq = torch.complex(r[..., 0], r[..., 1]).to(self.device)
        return iq, self.init_state()
