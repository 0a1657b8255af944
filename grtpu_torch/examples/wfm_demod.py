"""WBFM file demodulator app (the uhd_fft/gr_plot workflow's offline half):
IQ capture -> WfmRcv -> WAV.

Run: python -m grtpu_torch.examples.wfm_demod capture.cfile out.wav \
         --rate 256e3 --decim 8 [--device cpu]
"""

import argparse

import numpy as np
import torch

from grtpu_torch import Graph, StreamExecutor
from grtpu_torch.runtime.block import Port
from grtpu_torch.blocks.gengen import VectorSink
from grtpu_torch.io.file import load_capture, save_wav
from grtpu_torch.models.fm import WfmRcv
from grtpu_torch.utils.eng_notation import str_to_num


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("capture")
    ap.add_argument("wav_out")
    ap.add_argument("--rate", default="256k", help="IQ sample rate")
    ap.add_argument("--decim", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)

    rate = str_to_num(args.rate)
    iq = load_capture(args.capture, np.complex64)
    print(f"{len(iq)} samples @ {rate:g} Hz")

    g = Graph()
    pin = g.add_input(Port(torch.complex64))
    sink = VectorSink(torch.float32)
    g.connect(pin, WfmRcv(rate, args.decim), sink)
    ex = StreamExecutor(g, chunk_size=args.chunk, device=args.device)
    ex.run(iq)
    audio = sink.data()
    peak = np.abs(audio).max() or 1.0
    save_wav(args.wav_out, int(rate / args.decim), audio / peak * 0.9)
    print(f"wrote {args.wav_out}: {len(audio)} samples @ {rate/args.decim:g} Hz")


if __name__ == "__main__":
    main()
