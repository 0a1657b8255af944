"""Offline capture plotting CLIs — the gr-utils analogs.

Port of ``grtpu.utils.plot`` (host numpy; matplotlib imported only when a
plot is drawn).

Analog of gr-utils/src/python gr_plot_* family (SURVEY.md §2.8):
matplotlib viewers for raw binary captures (time, PSD, spectrogram,
constellation).  Headless-friendly: writes PNGs (the Agg backend) instead
of requiring a GUI.

CLI:  python -m grtpu_torch.utils.plot <time|iq|fft|psd|spec|const> capture.cfile \
          [--dtype complex64] [--rate 1e6] [--out plot.png]

Kind mapping to the reference CLIs: time/iq = gr_plot_iq / gr_plot_float /
gr_plot_char/short/int (pick --dtype), fft = gr_plot_fft{,_c,_f} (dual
time+spectrum view at --start), psd = gr_plot_psd{,_c,_f},
const = gr_plot_const, spec = the qt waterfall's offline analog.
"""

from __future__ import annotations

import argparse

import numpy as np


def _load(path, dtype, start, count):
    dt = np.dtype(dtype)
    return np.fromfile(path, dtype=dt, count=count,
                       offset=start * dt.itemsize)


def plot_time(data, rate, out, title="time"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(data)) / rate
    fig, ax = plt.subplots(figsize=(10, 4))
    if np.iscomplexobj(data):
        ax.plot(t, data.real, label="I", lw=0.7)
        ax.plot(t, data.imag, label="Q", lw=0.7)
        ax.legend()
    else:
        ax.plot(t, data, lw=0.7)
    ax.set_xlabel("time [s]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    return out


def plot_psd(data, rate, out, nfft=4096, title="PSD"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.psd(data, NFFT=min(nfft, len(data)), Fs=rate)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    return out


def plot_spectrogram(data, rate, out, nfft=1024, title="spectrogram"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    ax.specgram(data, NFFT=nfft, Fs=rate, noverlap=nfft // 2)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("freq [Hz]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    return out


def plot_constellation(data, out, title="constellation"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(np.real(data), np.imag(data), ".", ms=1.5, alpha=0.5)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    return out


def plot_fft(data, rate, out, nfft=4096, title="fft"):
    """gr_plot_fft's dual view: the time slice and its spectrum."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(nfft, len(data))
    seg = data[:n]
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(10, 7))
    t = np.arange(n) / rate
    if np.iscomplexobj(seg):
        ax0.plot(t, seg.real, lw=0.7, label="I")
        ax0.plot(t, seg.imag, lw=0.7, label="Q")
        ax0.legend()
        spec = np.fft.fftshift(np.fft.fft(seg))
        f = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / rate))
    else:
        ax0.plot(t, seg, lw=0.7)
        spec = np.fft.rfft(seg)
        f = np.fft.rfftfreq(n, 1.0 / rate)
    ax0.set_xlabel("time [s]")
    ax1.plot(f, 20 * np.log10(np.abs(spec) + 1e-12), lw=0.7)
    ax1.set_xlabel("freq [Hz]")
    ax1.set_ylabel("mag [dB]")
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    return out


# gr_plot_{char,short,int,float,iq} dtype shorthands
_DTYPE_ALIASES = {"char": "int8", "uchar": "uint8", "short": "int16",
                  "int": "int32", "float": "float32", "complex": "complex64",
                  "iq": "complex64"}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grtpu_torch.utils.plot")
    ap.add_argument("kind", choices=["time", "iq", "fft", "psd", "spec",
                                     "const"])
    ap.add_argument("path")
    ap.add_argument("--dtype", default="complex64")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, default=1 << 20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dtype = _DTYPE_ALIASES.get(args.dtype, args.dtype)
    data = _load(args.path, dtype, args.start, args.count)
    out = args.out or (args.path + f".{args.kind}.png")
    if args.kind in ("time", "iq"):
        plot_time(data, args.rate, out)
    elif args.kind == "fft":
        plot_fft(data, args.rate, out)
    elif args.kind == "psd":
        plot_psd(data, args.rate, out)
    elif args.kind == "spec":
        plot_spectrogram(data, args.rate, out)
    else:
        plot_constellation(data, out)
    print(out)


if __name__ == "__main__":
    main()
