"""Filter design CLI — the gr_filter_design analog (headless).

Port of ``grtpu.utils.filter_design`` over grtpu_torch's own ``firdes`` and
``optfir`` copies (identical taps).

The reference ships a PyQt designer (gr-utils gr_filter_design.py); this is
the same capability as a CLI: design with firdes/optfir, print taps, and
optionally render the frequency response to a PNG.

Examples:
  python -m grtpu_torch.utils.filter_design lowpass --fs 48000 --cutoff 8000 \
      --transition 2000 --window hamming --plot lp.png
  python -m grtpu_torch.utils.filter_design rrc --fs 4 --symbol-rate 1 \
      --alpha 0.35 --ntaps 45
  python -m grtpu_torch.utils.filter_design optlow --fs 48000 --cutoff 8000 \
      --stop 10000 --ripple 0.5 --atten 60
"""

from __future__ import annotations

import argparse

import numpy as np

from grtpu_torch.utils import firdes, optfir

_WINDOWS = {
    "hamming": firdes.Window.HAMMING, "hann": firdes.Window.HANN,
    "blackman": firdes.Window.BLACKMAN, "rect": firdes.Window.RECTANGULAR,
    "kaiser": firdes.Window.KAISER,
    "blackman-harris": firdes.Window.BLACKMAN_HARRIS,
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grtpu_torch.utils.filter_design")
    ap.add_argument("kind", choices=["lowpass", "highpass", "bandpass",
                                     "rrc", "gaussian", "hilbert", "optlow"])
    ap.add_argument("--fs", type=float, default=1.0)
    ap.add_argument("--gain", type=float, default=1.0)
    ap.add_argument("--cutoff", type=float, default=0.25)
    ap.add_argument("--cutoff2", type=float, default=0.4,
                    help="upper edge for bandpass")
    ap.add_argument("--transition", type=float, default=0.05)
    ap.add_argument("--stop", type=float, default=0.3,
                    help="stopband edge for optlow")
    ap.add_argument("--ripple", type=float, default=0.5, help="dB")
    ap.add_argument("--atten", type=float, default=60.0, help="dB")
    ap.add_argument("--window", choices=sorted(_WINDOWS), default="hamming")
    ap.add_argument("--beta", type=float, default=6.76)
    ap.add_argument("--symbol-rate", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.35)
    ap.add_argument("--bt", type=float, default=0.35)
    ap.add_argument("--spb", type=float, default=4.0)
    ap.add_argument("--ntaps", type=int, default=0)
    ap.add_argument("--plot", default=None, help="write response PNG")
    ap.add_argument("--save", default=None, help="write taps .f32 file")
    args = ap.parse_args(argv)

    w = _WINDOWS[args.window]
    if args.kind == "lowpass":
        taps = (firdes.low_pass_2(args.gain, args.fs, args.cutoff,
                                  args.ntaps, w, args.beta) if args.ntaps
                else firdes.low_pass(args.gain, args.fs, args.cutoff,
                                     args.transition, w, args.beta))
    elif args.kind == "highpass":
        taps = firdes.high_pass(args.gain, args.fs, args.cutoff,
                                args.transition, w, args.beta)
    elif args.kind == "bandpass":
        taps = firdes.band_pass(args.gain, args.fs, args.cutoff,
                                args.cutoff2, args.transition, w, args.beta)
    elif args.kind == "rrc":
        taps = firdes.root_raised_cosine(args.gain, args.fs,
                                         args.symbol_rate, args.alpha,
                                         args.ntaps or 45)
    elif args.kind == "gaussian":
        taps = firdes.gaussian(args.gain, args.spb, args.bt,
                               args.ntaps or 32)
    elif args.kind == "hilbert":
        taps = firdes.hilbert(args.ntaps or 65, w, args.beta)
    else:  # optlow
        taps = optfir.low_pass(args.gain, args.fs, args.cutoff, args.stop,
                               args.ripple, args.atten)

    print(f"# {args.kind}: {len(taps)} taps")
    print(", ".join(f"{t:.8g}" for t in np.asarray(taps)))
    if args.save:
        np.asarray(taps, np.float32).tofile(args.save)
        print(f"# wrote {args.save}")
    if args.plot:
        import scipy.signal as sig
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        freq, h = sig.freqz(taps, fs=args.fs, worN=2048)
        fig, ax = plt.subplots(figsize=(9, 4))
        ax.plot(freq, 20 * np.log10(np.maximum(np.abs(h), 1e-9)))
        ax.set_xlabel("Hz")
        ax.set_ylabel("dB")
        ax.grid(True, alpha=0.3)
        ax.set_title(f"{args.kind} ({len(taps)} taps)")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print(f"# wrote {args.plot}")


if __name__ == "__main__":
    main()
