"""Out-of-tree module scaffold CLI.

Port of ``grtpu.utils.scaffold``: the module it writes extends grtpu_torch
(a torch ``Block``), and its QA test runs on the CPU.

Analog of gr-utils' ``create-gnuradio-out-of-tree-project`` and the
``gr-howto-write-a-block`` template (SURVEY.md §2.8): generates a minimal
extension package — one example block (the howto ``square_ff``), a golden
test in the repo's house style, and a README describing the Block
contract — so third parties extend the framework the supported way.

Usage: python -m grtpu_torch.utils.scaffold my_module [--dir PATH]
"""

from __future__ import annotations

import argparse
import os

_INIT = '''"""{name}: an out-of-tree grtpu_torch extension module."""

from {name}.blocks import SquareFF

__all__ = ["SquareFF"]
'''

_BLOCKS = '''"""Example blocks for {name}.

The grtpu_torch Block contract (see grtpu_torch.runtime.block, and
gr-howto-write-a-block in the original GNU Radio for the ancestry):

  * declare ``in_ports`` / ``out_ports`` (Port(dtype, vlen)) before
    calling ``super().__init__``;
  * optionally declare ``history`` (the executor prepends that many
    items minus one of carried halo), ``decim`` / ``interp`` (static
    rates);
  * implement ``apply(state, *inputs) -> (state, outputs)`` over torch
    tensors on the executor's device — no host reads, so the step can be
    replayed from a CUDA graph (``run(device_loop=True)``);
  * keep constants as host numpy and move them to the device once; carry
    any recursion in ``state``.
"""

import torch

from grtpu_torch.runtime.block import Block, Port


class SquareFF(Block):
    """howto_square_ff: y[i] = x[i]**2 (the canonical example block)."""

    def __init__(self, name=None):
        self.in_ports = (Port(torch.float32),)
        self.out_ports = (Port(torch.float32),)
        super().__init__(name)

    def apply(self, state, x):
        return state, x * x
'''

_TEST = '''"""Golden tests for {name} (gr_unittest style: tiny graph,
vector fixtures, tolerance asserts), on the CPU."""

import numpy as np
import torch

from grtpu_torch import Graph, StreamExecutor
from grtpu_torch.runtime.block import Port
from grtpu_torch.blocks.gengen import VectorSink

from {name} import SquareFF


def test_square_ff():
    g = Graph()
    pin = g.add_input(Port(torch.float32))
    sink = VectorSink()
    g.connect(pin, SquareFF(), sink)
    ex = StreamExecutor(g, chunk_size=32, device="cpu")
    x = np.linspace(-3, 3, 64).astype(np.float32)
    ex.run(x)
    np.testing.assert_allclose(sink.data(), x * x, rtol=1e-6)
'''

_README = '''# {name}

An out-of-tree grtpu_torch extension module (scaffolded by
``python -m grtpu_torch.utils.scaffold``).

Run the tests (from this directory; add the grtpu_torch checkout to
PYTHONPATH if grtpu_torch is not installed on sys.path):

    env PYTHONPATH=.:/path/to/checkout python -m pytest tests -q

Add blocks in ``{name}/blocks.py`` following the Block contract described
there; wire them into flowgraphs exactly like built-in blocks.
'''


def create(name: str, base_dir: str = ".") -> str:
    if not name.isidentifier():
        raise ValueError(f"{name!r} is not a valid python package name")
    root = os.path.join(base_dir, name)
    pkg = os.path.join(root, name)
    tests = os.path.join(root, "tests")
    os.makedirs(pkg, exist_ok=False)
    os.makedirs(tests, exist_ok=True)
    with open(os.path.join(pkg, "__init__.py"), "w") as f:
        f.write(_INIT.format(name=name))
    with open(os.path.join(pkg, "blocks.py"), "w") as f:
        f.write(_BLOCKS.format(name=name))
    with open(os.path.join(tests, f"test_{name}.py"), "w") as f:
        f.write(_TEST.format(name=name))
    with open(os.path.join(root, "README.md"), "w") as f:
        f.write(_README.format(name=name))
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grtpu_torch.utils.scaffold",
                                 description=__doc__)
    ap.add_argument("name", help="module name (python identifier)")
    ap.add_argument("--dir", default=".", help="parent directory")
    args = ap.parse_args(argv)
    root = create(args.name, args.dir)
    print(root)


if __name__ == "__main__":
    main()
