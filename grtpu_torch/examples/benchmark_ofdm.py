"""OFDM loopback benchmark app — the ofdm/benchmark_tx+rx analog.

Analog of gr-digital/examples/ofdm/benchmark_{tx,rx}.py over the
grtpu_torch OFDM stack, including the dmr fork's channel-estimate export
(digital_ofdm_frame_sink.cc:422-423 apurv++ outputs): each received frame
reports BER AND the per-subcarrier channel magnitudes.

Run: python -m grtpu_torch.examples.benchmark_ofdm --snr 18 --frames 4 \
         --multipath [--device cpu]
     python -m grtpu_torch.examples.benchmark_ofdm --curve   # BER vs SNR,
                                                  # burst AND streaming rx
"""

import argparse

import numpy as np

from grtpu_torch.digital.ofdm import OfdmModem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--symbols", type=int, default=8, help="data symbols/frame")
    ap.add_argument("--cfo", type=float, default=0.002)
    ap.add_argument("--multipath", action="store_true")
    ap.add_argument("--fft", type=int, default=64)
    ap.add_argument("--curve", action="store_true",
                    help="BER-vs-SNR curve: burst modem vs the streaming "
                         "OfdmReceiver graph (the curve must match the "
                         "burst modem)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)
    if args.curve:
        return curve(args)

    m = OfdmModem(fft_len=args.fft, occupied=48, device=args.device)
    rng = np.random.RandomState(0)
    h = (np.array([1.0, 0.0, 0.25 - 0.1j], np.complex64)
         if args.multipath else np.array([1.0], np.complex64))

    total = ok = 0
    for f in range(args.frames):
        bits = rng.randint(0, 2, args.symbols * 48 * 2).astype(np.uint8)
        tx = m.modulate(bits)
        sig = np.convolve(tx, h)[: len(tx)]
        sig = sig * np.exp(1j * args.cfo * np.arange(len(sig)))
        sig = np.concatenate([np.zeros(150, np.complex64), sig,
                              np.zeros(100, np.complex64)])
        p = (np.abs(tx) ** 2).mean()
        n0 = p / 10 ** (args.snr / 10)
        sig = sig + (rng.randn(len(sig)) + 1j * rng.randn(len(sig))) * \
            np.sqrt(n0 / 2)
        got, chan, cfo_est, d = m.demodulate(sig.astype(np.complex64),
                                             args.symbols)
        got = got.cpu().numpy()[: len(bits)]
        ber = (got != bits).mean()
        total += 1
        ok += ber < 0.02
        cm = chan.abs().cpu().numpy()
        print(f"frame {f}: sync@{int(d):4d} cfo_est={float(cfo_est):+.5f} "
              f"ber={ber:.4f}  |H| mean={cm.mean():.2f} "
              f"min={cm.min():.2f} max={cm.max():.2f}")
    print(f"\n{ok}/{total} frames under 2% BER "
          f"(SNR {args.snr} dB, CFO {args.cfo}, "
          f"{'multipath' if args.multipath else 'flat'} channel)")


def _make_burst(m, rng, nsym, snr_db, cfo, h, gap):
    bits = rng.randint(0, 2, nsym * 48 * 2).astype(np.uint8)
    tx = m.modulate(bits)
    sig = np.convolve(tx, h)[: len(tx)]
    sig = np.concatenate([np.zeros(gap, np.complex64), sig])
    sig = sig * np.exp(1j * cfo * np.arange(len(sig)))
    p = (np.abs(tx) ** 2).mean()
    n0 = p / 10 ** (snr_db / 10)
    sig = (sig + (rng.randn(len(sig)) + 1j * rng.randn(len(sig)))
           * np.sqrt(n0 / 2)).astype(np.complex64)
    return bits, sig


def curve(args, snrs=(8, 12, 16, 20, 25)):
    """BER vs SNR for (a) the burst OfdmModem and (b) the streaming
    OfdmReceiver graph — the two paths must track each other."""
    import json

    import torch

    from grtpu_torch.digital.ofdm import OfdmFrameSink, OfdmReceiver
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.runtime.executor import StreamExecutor
    from grtpu_torch.runtime.graph import Graph

    m = OfdmModem(fft_len=args.fft, occupied=48, device=args.device)
    nsym = args.symbols
    h = (np.array([1.0, 0.0, 0.25 - 0.1j], np.complex64)
         if args.multipath else np.array([1.0], np.complex64))
    for snr in snrs:
        rng = np.random.RandomState(int(snr * 10))
        # burst path
        errs_b = tot = 0
        sigs, bits_all = [], []
        for _ in range(args.frames):
            bits, sig = _make_burst(m, rng, nsym, snr, args.cfo, h, 200)
            got, _, _, _ = m.demodulate(sig, nsym)
            got = got.cpu().numpy()[: len(bits)]
            errs_b += int((got != bits).sum())
            tot += len(bits)
            sigs.append(sig)
            bits_all.append(bits)
        ber_burst = errs_b / tot
        # streaming path: same frames concatenated into one stream
        stream = np.concatenate(
            sigs + [np.zeros(1200, np.complex64)]).astype(np.complex64)
        rx = OfdmReceiver(m, nsym_data=nsym, sync_type="pn")
        g = Graph()
        pin = g.add_input(Port(torch.complex64))
        pb = g.add_output(Port(torch.uint8))
        pf = g.add_output(Port(torch.uint8))
        pc = g.add_output(Port(torch.complex64, m.occupied))
        g.connect(pin, rx)
        g.connect((rx, 0), OfdmFrameSink(m), pb)
        g.connect((rx, 1), pf)
        g.connect((rx, 2), pc)
        # chunk <= frame span + gap: at most one new frame start per chunk
        span = (nsym + 2) * (m.fft_len + m.cp_len)
        ex = StreamExecutor(g, chunk_size=span // 2 * 2, vr_chunks={rx: nsym},
                            device=args.device)
        bits_out, flags, _ = ex.run(stream)
        bits_out = bits_out.cpu().numpy()
        per = nsym * 48 * 2
        nfr = min(len(bits_out) // per, len(bits_all))
        errs_s = sum(int((bits_out[i * per:(i + 1) * per]
                          != bits_all[i]).sum()) for i in range(nfr))
        ber_stream = errs_s / max(nfr * per, 1)
        print(json.dumps({"snr_db": snr, "ber_burst": round(ber_burst, 5),
                          "ber_streaming": round(ber_stream, 5),
                          "frames_streaming": nfr}))


if __name__ == "__main__":
    main()
