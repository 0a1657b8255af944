"""How to write a block — the gr-howto-write-a-block analog.

The reference ships an out-of-tree module template (autotools + swig) whose
payload is one example block, howto_square_ff, plus QA.  In grtpu_torch an
out-of-tree block is just a Block subclass in your own package; this file
is the complete equivalent of that whole template.

Run: python -m grtpu_torch.examples.howto_write_a_block [--device cpu]
"""

import argparse

import numpy as np
import torch

from grtpu_torch.runtime.block import Block, Port
from grtpu_torch.utils.testing import run_block


class SquareFF(Block):
    """howto_square_ff: out = in * in.

    A stateless 1:1 block: declare ports, implement apply.  That's the
    whole extension API (the reference needs a C++ class, an .i swig file,
    autotools glue and a QA harness for the same thing).
    """

    def __init__(self, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)

    def apply(self, state, x):
        return state, x * x


class SquareAccumFF(Block):
    """A *stateful* variant showing carried state: running sum of squares."""

    def __init__(self, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)

    def init_state(self):
        return torch.zeros((), dtype=torch.float32)

    def apply(self, state, x):
        acc = state + torch.cumsum(x * x, 0)
        return acc[-1], acc


class ThresholdTagFF(Block):
    """A tag-EMITTING block: passthrough that tags every upward crossing
    of a threshold (the add_item_tag idiom, gr_burst_tagger-style).

    ``device_tags``: detection runs on the device — apply_tagged returns a
    small statically-shaped record (chunk-relative offsets, -1 padded) and
    tags_from_device turns it into Tag objects on the host.  This form
    works under step(), run(device_loop=True) and MeshExecutor alike.
    """

    emits_tags = True
    device_tags = True

    def __init__(self, threshold: float = 1.0, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)
        self.threshold = threshold

    def init_state(self):
        return torch.zeros((), dtype=torch.bool)      # previous "above" flag

    def apply(self, state, x):
        return (x[-1] > self.threshold), x

    def apply_tagged(self, state, x):
        above = x > self.threshold
        prev = torch.cat([state[None], above[:-1]])
        offs, _ = self._tag_topk(above & ~prev, x.shape[0])
        return above[-1], x, {"offset": offs}

    def tags_from_device(self, rec, start_in, start_out):
        from grtpu_torch.runtime.tags import Tag

        return [Tag(start_out + int(o), "rising", True, self.name)
                for o in rec["offset"] if o >= 0]


def qa_square_ff(device=None):
    """The template's qa_howto.py, in three lines."""
    src = np.array([-3, 4, -5.5, 2, 3], np.float32)
    out = run_block(SquareFF(), src, device=device)
    np.testing.assert_allclose(out, src ** 2, rtol=1e-6)
    print("qa_square_ff: OK", out)


def qa_square_accum_ff(device=None):
    src = np.ones(8, np.float32)
    out = run_block(SquareAccumFF(), src, chunk_size=4,  # state crosses chunks
                    device=device)
    np.testing.assert_allclose(out, np.arange(1, 9, dtype=np.float32))
    print("qa_square_accum_ff: OK", out)


def qa_threshold_tag_ff(device=None):
    from grtpu_torch import Graph, StreamExecutor
    from grtpu_torch.blocks.gengen import VectorSink

    src = np.array([0, 2, 0, 0, 3, 3, 0, 2], np.float32)
    g = Graph()
    pin = g.add_input(Port(torch.float32))
    s = VectorSink(dtype=torch.float32)
    g.connect(pin, ThresholdTagFF(1.0), s)
    ex = StreamExecutor(g, chunk_size=4, device=device)  # crossings span chunks
    ex.run(src)
    offs = sorted(t.offset for t in ex.sink_tags[s.name])
    assert offs == [1, 4, 7], offs
    print("qa_threshold_tag_ff: OK", offs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)
    qa_square_ff(args.device)
    qa_square_accum_ff(args.device)
    qa_threshold_tag_ff(args.device)


if __name__ == "__main__":
    main()
