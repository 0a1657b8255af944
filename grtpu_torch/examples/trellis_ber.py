"""Trellis-coding BER simulations (gr-trellis examples analog).

Covers the reference's gr-trellis/src/examples suite:
  * tcm    — trellis-coded modulation + Viterbi (test_tcm.py)
  * eq     — Viterbi equalization of an ISI channel
             (test_viterbi_equalization.py)
  * sccc     — serial turbo over 8PSK (test_sccc_turbo.py)
  * pccc     — parallel turbo (test_pccc_turbo1.py)
  * turbo-eq — turbo equalization of Proakis channel C
               (test_turbo_equalization.py: the ISI trellis is the SCCC
               inner code)

Each simulation runs its `rep` packets as one batch: every call below takes
the (rep, K) tensors at once, so the whole Monte-Carlo sweep is a handful of
batched device calls instead of the reference's one-packet-per-top_block
loop.  The Viterbi of tcm and eq is the hand kernel viterbi_fwd on the card.

Run: python -m grtpu_torch.examples.trellis_ber tcm -e 8.0 -r 64 [--device cpu]
"""

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from grtpu_torch.trellis import (
    FSM, Interleaver, calc_metric_cost, fsm_encode, fsm_utils,
    pccc_decoder, sccc_decoder, viterbi,
)
from grtpu_torch.utils.device import constant, resolve

# awgn1o2_4.fsm analog: rate-1/2 (5,7) code
FSM4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
# awgn2o3_4_msb.fsm analog (see tests/test_trellis_turbo.py)
FSM_MSB = FSM(4, 4, 8,
              NS=[0, 1, 2, 3] * 4,
              OS=[0, 5, 3, 6, 4, 1, 7, 2, 7, 2, 4, 1, 3, 6, 0, 5])
PSK8 = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
PAM4 = np.asarray(fsm_utils.pam4[1], np.float32)
# the constellations on each device they are used on, copied there once
_TABLES = SimpleNamespace(PSK8=PSK8, PAM4=PAM4)


def _packets(rng, rep, K, I, dev):
    return torch.from_numpy(rng.integers(0, I, (rep, K))).to(dev)


def _noise(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def sim_tcm(esn0_db, K, rep, seed, device=None):
    """QPSK-ish TCM: FSM4 -> 4-PAM -> AWGN -> metrics -> Viterbi."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I, dev)
    es = float(np.mean(PAM4 ** 2))
    n0 = es / 10 ** (esn0_db / 10)
    noise = _noise(np.sqrt(n0 / 2) * rng.standard_normal((rep, K)), dev)

    pam4 = constant(_TABLES, "PAM4", dev)
    _, syms = fsm_encode(FSM4, data)
    rx = pam4[syms.long()] + noise
    m = calc_metric_cost(rx, pam4, 1)
    dec = viterbi(FSM4, -m, 0, -1)
    return int((dec != data).sum()), rep * K


def sim_eq(esn0_db, K, rep, seed, device=None):
    """Viterbi equalization: 4-PAM through an ISI channel."""
    dev = resolve(device)
    channel = [0.9, 0.3, -0.2]
    fsm = FSM.from_isi(4, len(channel))
    dim, lookup = fsm_utils.make_isi_lookup(fsm_utils.pam4, channel, True)
    lut = np.asarray(lookup, np.float32)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, 4, dev)
    es = float(np.mean(lut ** 2))
    n0 = es / 10 ** (esn0_db / 10)
    noise = _noise(np.sqrt(n0 / 2) * rng.standard_normal((rep, K)), dev)

    lut = torch.from_numpy(lut).to(dev)
    _, out = fsm_encode(fsm, data)
    rx = lut[out.long()] + noise
    m = calc_metric_cost(rx, lut, dim)
    dec = viterbi(fsm, -m, 0, -1)
    return int((dec != data).sum()), rep * K


def sim_sccc(esn0_db, K, rep, seed, iterations, device=None):
    """SCCC turbo: (5,7) outer -> interleave -> msb inner -> 8PSK."""
    dev = resolve(device)
    il = Interleaver.random(K, seed=666)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I, dev)
    sigma = float(np.sqrt(1.0 / 10 ** (esn0_db / 10) / 2))
    noise = _noise(sigma * rng.standard_normal((rep, K, 2)), dev)
    INTER = torch.from_numpy(il.INTER).long().to(dev)

    psk8 = constant(_TABLES, "PSK8", dev)
    _, mid = fsm_encode(FSM4, data)
    _, syms = fsm_encode(FSM_MSB, mid[:, INTER])
    rx = psk8[syms.long()] + torch.complex(noise[..., 0], noise[..., 1])
    m = calc_metric_cost(rx, psk8, 1) / (2 * sigma ** 2)
    dec = sccc_decoder(FSM4, FSM_MSB, il, m, iterations)
    return int((dec != data).sum()), rep * K


def sim_pccc(esn0_db, K, rep, seed, iterations, device=None):
    """PCCC turbo: two (5,7) codes in parallel, 2x4-PAM."""
    dev = resolve(device)
    il = Interleaver.random(K, seed=666)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I, dev)
    table = np.zeros((FSM4.O * FSM4.O, 2), np.float32)
    for o1 in range(FSM4.O):
        for o2 in range(FSM4.O):
            table[o1 * FSM4.O + o2] = (PAM4[o1], PAM4[o2])
    es = 2 * float(np.mean(PAM4 ** 2))
    sigma = float(np.sqrt(es / 2 / 10 ** (esn0_db / 10)))
    noise = _noise(sigma * rng.standard_normal((rep, K, 2)), dev)
    INTER = torch.from_numpy(il.INTER).long().to(dev)

    pam4 = constant(_TABLES, "PAM4", dev)
    _, o1 = fsm_encode(FSM4, data)
    _, o2 = fsm_encode(FSM4, data[:, INTER])
    rx = torch.stack([pam4[o1.long()], pam4[o2.long()]], -1) + noise
    m = calc_metric_cost(rx.reshape(rep, -1), torch.from_numpy(table).to(dev),
                         2) / sigma ** 2
    dec = pccc_decoder(FSM4, FSM4, il, m, iterations)
    return int((dec != data).sum()), rep * K


def sim_turbo_eq(esn0_db, K, rep, seed, iterations, device=None):
    """Turbo equalization (test_turbo_equalization.py): outer (5,7) code ->
    interleave -> 4-PAM through Proakis channel C; the ISI trellis acts as
    the SCCC inner 'code', so the receiver IS the SCCC turbo loop."""
    dev = resolve(device)
    channel = list(fsm_utils.c_channel)
    fsm_i = FSM.from_isi(4, len(channel))
    dim, lookup = fsm_utils.make_isi_lookup(fsm_utils.pam4, channel, True)
    lut = np.asarray(lookup, np.float32)
    il = Interleaver.random(K, seed=666)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I, dev)
    es = float(np.mean(lut ** 2))
    n0 = es / 10 ** (esn0_db / 10)
    noise = _noise(np.sqrt(n0 / 2) * rng.standard_normal((rep, K)), dev)
    INTER = torch.from_numpy(il.INTER).long().to(dev)

    lut = torch.from_numpy(lut).to(dev)
    _, mid = fsm_encode(FSM4, data)
    _, out = fsm_encode(fsm_i, mid[:, INTER])
    rx = lut[out.long()] + noise
    m = calc_metric_cost(rx, lut, dim)
    dec = sccc_decoder(FSM4, fsm_i, il, m, iterations)
    return int((dec != data).sum()), rep * K


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scheme",
                    choices=["tcm", "eq", "sccc", "pccc", "turbo-eq"])
    ap.add_argument("-e", "--esn0", type=float, default=10.0,
                    help="Es/N0 in dB")
    ap.add_argument("-K", type=int, default=1024,
                    help="packet size in trellis steps")
    ap.add_argument("-r", "--repetitions", type=int, default=32)
    ap.add_argument("-i", "--iterations", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)

    dev = args.device
    if args.scheme == "tcm":
        errs, total = sim_tcm(args.esn0, args.K, args.repetitions, args.seed,
                              dev)
    elif args.scheme == "eq":
        errs, total = sim_eq(args.esn0, args.K, args.repetitions, args.seed,
                             dev)
    elif args.scheme == "sccc":
        errs, total = sim_sccc(args.esn0, args.K, args.repetitions,
                               args.seed, args.iterations, dev)
    elif args.scheme == "pccc":
        errs, total = sim_pccc(args.esn0, args.K, args.repetitions,
                               args.seed, args.iterations, dev)
    else:
        errs, total = sim_turbo_eq(args.esn0, args.K, args.repetitions,
                                   args.seed, args.iterations, dev)
    print(f"{args.scheme}: Es/N0={args.esn0:.1f} dB  {total} symbols  "
          f"{errs} errors  SER={errs / total:.3e}")


if __name__ == "__main__":
    main()
