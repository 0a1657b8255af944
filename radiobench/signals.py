"""Input signals, made on the device from the seed in a few large calls.

Frozen copies, in plain PyTorch, of the generators that drove the port on
the card before this benchmark existed: ``chip_smoke.py``'s
``wideband_capture`` (FM stations at the configuration's offsets, noise)
and its ``dmr_frames`` / ``dmr_channel`` (DMR bursts with the BS-data sync
and random payloads, a carrier offset, complex noise), with the 4FSK
transmitter written out here instead of taken from the program.  The same
seed gives the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radiobench.reference import designs

# ETSI TS 102 361-1 BS-sourced data sync, 48 bits (24 dibits)
BS_DATA_SYNC = 0xDFF57D75DF5D
SLOT_DIBITS = 144        # a 30 ms slot at 4,800 symbols/s
CACH_DIBITS = 12         # the 2.5 ms common announcement channel
PAYLOAD_HALF_DIBITS = 54
FSK4_LEVELS = (1.0, 3.0, -1.0, -3.0)   # dibits 00, 01, 10, 11


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one named stream of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def complex_noise(shape, sigma: float, gen, device) -> torch.Tensor:
    return torch.complex(
        torch.randn(shape, generator=gen, device=device) * sigma,
        torch.randn(shape, generator=gen, device=device) * sigma)


def wideband_capture(cfg: dict, n: int, count: int, seed: int, device) -> torch.Tensor:
    """(count, n) complex64 captures at ``cfg["capture_rate"]``: each
    station of ``cfg["stations"]`` FM-modulated by a tone of its own (the
    tone's frequency and phase drawn from the seed, ``cfg["message"]``),
    plus complex noise of ``cfg["noise_per_dim"]`` a dimension."""
    fs = float(cfg["capture_rate"])
    rng = host_rng(seed, 1)
    gen = generator(seed, 1, device)
    lo, hi = cfg["message"]["tone_hz"]
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    out = torch.empty((count, n), dtype=torch.complex64, device=device)
    for c in range(count):
        x = torch.zeros(n, dtype=torch.complex128, device=device)
        for st in cfg["stations"]:
            f_tone = rng.uniform(lo, hi)
            msg = cfg["message"]["amplitude"] * torch.sin(
                2 * math.pi * f_tone * t + rng.uniform(0, 2 * math.pi))
            k = 2 * math.pi * st["deviation_hz"] / fs
            phase = 2 * math.pi * st["offset_hz"] * t + k * torch.cumsum(msg, 0)
            x += st["amplitude"] * torch.polar(torch.ones_like(phase), phase)
        out[c] = x.to(torch.complex64) + complex_noise(
            n, cfg["noise_per_dim"], gen, device)
    return out


def dmr_dibits(rows: int, n_symbols: int, seed: int, stream: int,
               device) -> torch.Tensor:
    """(rows, n_symbols) uint8 dibits: back-to-back 144-symbol slots, each
    12 random CACH dibits, then a burst of 54 random payload dibits, the
    24-dibit BS-data sync and 54 more random payload dibits."""
    slots = -(-n_symbols // SLOT_DIBITS)
    gen = generator(seed, stream, device)
    d = torch.randint(0, 4, (rows, slots, SLOT_DIBITS), generator=gen,
                      device=device, dtype=torch.uint8)
    sync = torch.tensor([(BS_DATA_SYNC >> (46 - 2 * i)) & 3 for i in range(24)],
                        dtype=torch.uint8, device=device)
    at = CACH_DIBITS + PAYLOAD_HALF_DIBITS
    d[:, :, at:at + 24] = sync
    return d.reshape(rows, -1)[:, :n_symbols]


def fsk4_modulate(dibits: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(rows, n_sym) dibits -> (rows, n_sym * sps) complex128 baseband:
    levels +-1/3, +-1 (a unit deviation), the root-raised-cosine pulse at
    gain sps on the zero-stuffed symbols, then FM at ``cfg["deviation_hz"]``
    from phase 0."""
    sps = int(cfg["samples_per_symbol"])
    fs = sps * float(cfg["symbol_rate"])
    shape = designs.rrc(sps, sps, 1.0, cfg["rrc_alpha"], cfg["rrc_taps"])
    lut = torch.tensor(FSK4_LEVELS, dtype=torch.float64, device=dibits.device) / 3
    rows, n_sym = dibits.shape
    up = torch.zeros((rows, n_sym * sps), dtype=torch.float64, device=dibits.device)
    up[:, ::sps] = lut[dibits.long()]
    h = torch.from_numpy(shape[::-1].copy()).to(dibits.device)
    shaped = torch.nn.functional.conv1d(
        torch.nn.functional.pad(up, (len(shape) - 1, 0))[:, None], h[None, None])[:, 0]
    sens = 2 * math.pi * cfg["deviation_hz"] / fs
    phase = torch.cumsum(sens * shaped, dim=1)
    return torch.polar(torch.ones_like(phase), phase)


def dmr_channel(iq: torch.Tensor, cfg: dict, seed: int, stream: int) -> torch.Tensor:
    """A carrier offset per row, uniform within +-``cfo_hz``, and complex
    noise at ``snr_db`` below the mean power of all rows; complex64."""
    rows, n = iq.shape
    fs = int(cfg["samples_per_symbol"]) * float(cfg["symbol_rate"])
    cfo = torch.from_numpy(host_rng(seed, stream).uniform(
        -cfg["cfo_hz"], cfg["cfo_hz"], rows)).to(iq.device)
    t = torch.arange(n, dtype=torch.float64, device=iq.device) / fs
    rot = torch.polar(torch.ones((rows, n), dtype=torch.float64, device=iq.device),
                      2 * math.pi * cfo[:, None] * t[None, :])
    p = float((iq.abs() ** 2).mean())
    sigma = math.sqrt(p / 10 ** (cfg["snr_db"] / 10) / 2)
    gen = generator(seed, stream, iq.device)
    return (iq * rot).to(torch.complex64) + complex_noise((rows, n), sigma, gen, iq.device)
