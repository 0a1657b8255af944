"""Digital loopback benchmark app — the benchmark_tx/benchmark_rx analog.

Analog of gr-digital/examples/narrowband/benchmark_{tx,rx}.py + tunnel.py's
packet loop (SURVEY.md §3.4): send framed packets through a modem + channel
model, receive, and report per-packet CRC results via the rx callback.

Run: python -m grtpu_torch.examples.benchmark_tx_rx --modulation gmsk \
         --snr 12 -n 20 [--device cpu]
"""

import argparse

import numpy as np

from grtpu_torch.digital import packet
from grtpu_torch.digital.modems import Fsk4Modem, GmskModem, PskModem, awgn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modulation", default="gmsk",
                    choices=["gmsk", "dbpsk", "4fsk"])
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--cfo", type=float, default=0.0,
                    help="carrier offset, rad/sample")
    ap.add_argument("-n", "--npackets", type=int, default=10)
    ap.add_argument("--size", type=int, default=64, help="payload bytes")
    ap.add_argument("--sps", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)

    if args.modulation == "gmsk":
        modem = GmskModem(samples_per_symbol=args.sps, device=args.device)
    elif args.modulation == "dbpsk":
        modem = PskModem(m=2, samples_per_symbol=args.sps, device=args.device)
    else:
        modem = Fsk4Modem(samples_per_symbol=max(args.sps, 5),
                          device=args.device)

    n_ok = n_right = 0
    rng = np.random.RandomState(0)
    for pktno in range(args.npackets):
        payload = bytes([pktno & 0xFF]) + bytes(
            rng.randint(0, 256, args.size - 1).astype(np.uint8))
        bits = packet.make_packet(payload)
        idle = rng.randint(0, 2, 64).astype(np.uint8)
        stream = np.concatenate([idle, bits, idle])
        if args.modulation == "4fsk":
            dib = np.concatenate([stream, np.zeros(len(stream) % 2,
                                                   np.uint8)])
            dib = (dib[0::2] << 1) | dib[1::2]
            tx = modem.modulate(dib)
        else:
            tx = modem.modulate(stream)
        tx = tx.cpu().numpy()
        if args.cfo:
            tx = tx * np.exp(1j * args.cfo * np.arange(len(tx)))
        rx_raw = modem.demodulate(awgn(tx, args.snr, seed=pktno))
        if args.modulation == "4fsk":
            rx_bits = np.stack([(rx_raw >> 1) & 1, rx_raw & 1],
                               axis=1).reshape(-1)
        else:
            rx_bits = rx_raw
        idx = packet.find_access_code(rx_bits, threshold=2)
        ok = False
        right = False
        if idx is not None:
            hdr = packet.parse_header(
                packet.bits_to_bytes(rx_bits[idx: idx + 32]))
            if hdr is not None:
                plen, off = hdr
                body = rx_bits[idx + 32: idx + 32 + plen * 8]
                ok, msg = packet.unmake_packet(body, off)
                right = ok and msg == payload
        n_ok += ok
        n_right += right
        print(f"pktno {pktno:4d}  crc {'OK ' if ok else 'BAD'}  "
              f"payload {'match' if right else 'MISMATCH' if ok else '-'}")
    print(f"\n{n_right}/{args.npackets} packets received intact "
          f"({args.modulation}, SNR {args.snr} dB, CFO {args.cfo})")


if __name__ == "__main__":
    main()
