"""digital_bert — BER tester (digital_bert_tx.py + digital_bert_rx.py in
one loopback process; gr-digital/examples/narrowband/).

Streams the CCSDS-scrambled all-ones BERT sequence through a generic
modem, an impaired channel, and the generic receive chain, printing the
reference status line (Freq. Offset / Timing Offset / SNR / BER) per
chunk.

Usage:  python -m grtpu_torch.examples.digital_bert [-m 2|4|8] [--snr dB]
        [--cfo f] [-n bits] [-s sps] [--device cpu]
"""
import argparse

import numpy as np

from grtpu_torch.digital.bert import BertReceive, BertTransmit


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", type=int, default=2, help="PSK order")
    p.add_argument("-s", "--sps", type=int, default=4)
    p.add_argument("-n", "--nbits", type=int, default=1 << 14,
                   help="bits per chunk")
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--snr", type=float, default=None, help="channel SNR dB")
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset, cycles/sample")
    p.add_argument("--sample-rate", type=float, default=1e6)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card, cuda)")
    args = p.parse_args(argv)

    tx = BertTransmit(m=args.m, samples_per_symbol=args.sps,
                      device=args.device)
    rx = BertReceive(m=args.m, samples_per_symbol=args.sps,
                     device=args.device)
    r = np.random.RandomState(0)
    for _ in range(args.chunks):
        x = tx.samples(args.nbits)
        if args.cfo:
            n = np.arange(len(x))
            x = x * np.exp(2j * np.pi * args.cfo * n).astype(np.complex64)
        if args.snr is not None:
            pwr = np.mean(np.abs(x) ** 2)
            sigma = np.sqrt(pwr / (2 * 10 ** (args.snr / 10)))
            x = x + sigma * (r.randn(len(x)) + 1j * r.randn(len(x)))
        rx.process(x.astype(np.complex64))
        print("Freq. Offset: {0:5.0f} Hz  Timing Offset: {1:10.1f} ppm  "
              "Estimated SNR: {2:4.1f} dB  BER: {3:g}".format(
                  rx.frequency_offset(args.sample_rate),
                  rx.timing_offset() * 1e6, rx.snr(), rx.ber()))


if __name__ == "__main__":
    main()
