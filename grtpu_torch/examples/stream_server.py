"""Streaming service: UDP samples in -> flowgraph -> UDP audio out.

The production-serving shape of the framework: a long-running process
ingesting a raw IQ sample stream over the network (the reference's
gr_udp_source deployment idiom, gnuradio-examples/python/network/), running
the WBFM receiver chunk by chunk on the card, and streaming demodulated
audio back out.  Ingest uses the native C++ data plane when available
(receiver thread -> double-mapped ring) so datagram handling never blocks
the chunk loop.

Run:  python -m grtpu_torch.examples.stream_server --in-port 9000 \
          --out-host 127.0.0.1 --out-port 9001 [--quad-rate 256e3] \
          [--audio-decim 8] [--device cpu]
Feed: any 256 ksps complex64 IQ stream over UDP (zero-length datagram
      terminates the service), e.g. grtpu_torch.io.udp.UdpSink.
"""

import argparse

import numpy as np


def serve(in_port: int, out_host: str, out_port: int,
          quad_rate: float = 256e3, audio_decim: int = 8,
          chunk: int = 8192, in_host: str = "", native: bool = True,
          on_ready=None, device=None):
    """Run the service until a zero-length datagram arrives.

    ``on_ready`` (optional) is called once the input socket is bound —
    in-process embedders (tests, supervisors) should wait on it before
    transmitting instead of sleeping: graph build + executor init happen
    first, and datagrams sent before the bind are silently lost.
    ``device`` is where the receiver runs (the card unless named)."""
    import torch

    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.runtime.block import Port
    from grtpu_torch.models.fm import WfmRcv
    from grtpu_torch.io import udp
    from grtpu_torch.io import native as native_io

    g = Graph("wfm_server")
    pin = g.add_input(Port(torch.complex64))
    pout = g.add_output(Port(torch.float32))
    g.connect(pin, WfmRcv(quad_rate, audio_decim), pout)
    ex = StreamExecutor(g, chunk_size=chunk, device=device)

    if native and native_io.available():
        src = udp.native_udp_source(in_host, in_port, np.complex64)
    else:
        src = udp.UdpSource(in_host or "0.0.0.0", in_port, np.complex64,
                            timeout=5.0)
    snk = udp.UdpSink(out_host, out_port, np.float32)
    if on_ready is not None:
        on_ready()
    n_in = n_out = 0
    try:
        for audio in ex.stream(src.chunks(chunk)):
            a = audio.cpu().numpy()
            snk.write_items(a)
            n_in += chunk
            n_out += len(a)
    finally:
        snk.close()
        src.close()
    return n_in, n_out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--in-port", type=int, required=True)
    ap.add_argument("--in-host", default="")
    ap.add_argument("--out-host", default="127.0.0.1")
    ap.add_argument("--out-port", type=int, required=True)
    ap.add_argument("--quad-rate", type=float, default=256e3)
    ap.add_argument("--audio-decim", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--no-native", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)
    n_in, n_out = serve(args.in_port, args.out_host, args.out_port,
                        args.quad_rate, args.audio_decim, args.chunk,
                        args.in_host, native=not args.no_native,
                        device=args.device)
    print(f"served {n_in} IQ samples -> {n_out} audio samples")


if __name__ == "__main__":
    main()
