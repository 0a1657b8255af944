"""Declarative flowgraph compiler: YAML/JSON spec -> Graph -> script.

Port of ``grtpu.grc.flowgraph``.  Analog of the GRC pipeline (SURVEY.md
§3.5): flow_graph.grc XML -> Platform/FlowGraph model (grc/base/*.py,
ParseXML.py) -> Cheetah-rendered runnable top_block script
(grc/python/Generator.py:32-120).  Here the spec is YAML/JSON, the model is
:class:`FlowgraphSpec`, and generation renders a plain Python script over
the grtpu_torch API (or builds/runs the Graph directly).

Spec format::

    options: {chunk_size: 4096}
    blocks:
      - {id: src, key: gr_sig_source_x, params: {sampling_freq: 32000.0,
         waveform: cos, frequency: 1000.0}}
      - {id: sink, key: gr_vector_sink_x, params: {}}
    connections:
      - [src, 0, sink, 0]
    pads:
      inputs:  [{dtype: complex64}]      # optional external ports
      outputs: [{from: [blockid, port]}]

A spec's ``params`` are the block's keyword arguments, so a spec may name
what a ``.grc`` file cannot, e.g. ``blks2_wfm_rcv: {impl: kernel}`` to run
the audio filter on the hand kernel.  YAML needs PyYAML, imported only when
a ``.yml`` file is loaded; JSON and ``.grc`` need nothing beyond the
standard library.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import time
from typing import Any, Dict, List, Optional

import torch

from grtpu_torch.grc.registry import BLOCK_REGISTRY, refuse_unsupported
from grtpu_torch.runtime.block import Port
from grtpu_torch.runtime.graph import Graph

_DTYPES = {"complex64": torch.complex64, "float32": torch.float32,
           "int16": torch.int16, "int32": torch.int32, "uint8": torch.uint8}


@dataclasses.dataclass
class FlowgraphSpec:
    options: Dict[str, Any]
    blocks: List[Dict[str, Any]]
    connections: List[List[Any]]
    pads: Dict[str, List[Dict[str, Any]]]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FlowgraphSpec":
        return cls(options=d.get("options", {}), blocks=d.get("blocks", []),
                   connections=d.get("connections", []),
                   pads=d.get("pads", {}))

    def build(self):
        """Instantiate the Graph (+ id->block map)."""
        g = Graph(self.options.get("id", "flowgraph"))
        byid = {}
        for b in self.blocks:
            key = b["key"]
            refuse_unsupported(key, b["id"])
            if key not in BLOCK_REGISTRY:
                raise KeyError(f"unknown block key {key!r}")
            params = dict(b.get("params", {}))
            if "dtype" in params and isinstance(params["dtype"], str):
                params["dtype"] = _DTYPES[params["dtype"]]
            byid[b["id"]] = BLOCK_REGISTRY[key](**params)
        pads_in = []
        for p in self.pads.get("inputs", []):
            pads_in.append(g.add_input(Port(_DTYPES[p.get("dtype",
                                                         "complex64")])))
        for c in self.connections:
            src, sp, dst, dp = c
            if isinstance(src, str) and src.startswith("pad:"):
                g.connect(pads_in[int(src[4:])], (byid[dst], int(dp)))
            else:
                g.connect((byid[src], int(sp)), (byid[dst], int(dp)))
        for p in self.pads.get("outputs", []):
            blk, port = p["from"]
            out_port = byid[blk].out_ports[int(port)]
            pad = g.add_output(Port(out_port.dtype, out_port.vlen))
            g.connect((byid[blk], int(port)), pad)
        return g, byid


def load_flowgraph(path: str) -> FlowgraphSpec:
    """Load a .json or .yml flowgraph file."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yml", ".yaml")):
        import yaml

        return FlowgraphSpec.from_dict(yaml.safe_load(text))
    return FlowgraphSpec.from_dict(json.loads(text))


def _param(k, v) -> str:
    if k == "dtype" and isinstance(v, str):
        return f"dtype=torch.{v}"
    return f"{k}={v!r}"


def generate_script(spec: FlowgraphSpec, device: Optional[str] = None) -> str:
    """Render a standalone Python script (the Generator's Cheetah-template
    analog): reproduces the graph construction over the public API.  The
    executor runs on ``device`` where one is given, else on the card."""
    lines = [
        '"""Auto-generated by grtpu_torch.grc (the GRC Generator analog)."""',
        "import numpy as np",
        "import torch",
        "from grtpu_torch import Graph, StreamExecutor",
        "from grtpu_torch.runtime.block import Port",
        "from grtpu_torch.grc.registry import BLOCK_REGISTRY",
        "",
        "g = Graph()",
        "blocks = {}",
    ]
    for b in spec.blocks:
        refuse_unsupported(b["key"], b["id"])
        lines.append(
            f"blocks[{b['id']!r}] = BLOCK_REGISTRY[{b['key']!r}]("
            + ", ".join(_param(k, v) for k, v in b.get("params", {}).items())
            + ")")
    for p in spec.pads.get("inputs", []):
        lines.append(
            f"g.add_input(Port(torch.{p.get('dtype', 'complex64')}))")
    for c in spec.connections:
        src, sp, dst, dp = c
        if isinstance(src, str) and src.startswith("pad:"):
            lines.append(f"g.connect(g.input({int(src[4:])}), "
                         f"(blocks[{dst!r}], {dp}))")
        else:
            lines.append(f"g.connect((blocks[{src!r}], {sp}), "
                         f"(blocks[{dst!r}], {dp}))")
    for p in spec.pads.get("outputs", []):
        blk, port = p["from"]
        lines.append(
            f"_op = blocks[{blk!r}].out_ports[{port}]\n"
            f"g.connect((blocks[{blk!r}], {port}), "
            f"g.add_output(Port(_op.dtype, _op.vlen)))")
    cs = spec.options.get("chunk_size", 4096)
    steps = spec.options.get("steps", 16)
    dev = "" if device is None else f", device={device!r}"
    lines += [
        "",
        f"ex = StreamExecutor(g, chunk_size={cs}{dev})",
        "if __name__ == '__main__':",
        f"    ex.run(steps={steps})" if not spec.pads.get("inputs") else
        "    pass  # feed ex.run(<input arrays>)",
        "    print('flowgraph complete')",
    ]
    return "\n".join(lines)


def flush_sinks(byid) -> None:
    """Write the file-backed sinks (wav/file): every sink whose ``flush``
    takes no argument.  Flushes that need one (TaggedFileSink's tags) are
    the caller's."""
    for b in byid.values():
        if hasattr(b, "flush") and not getattr(b, "out_ports", ()):
            params = inspect.signature(b.flush).parameters
            if all(p.default is not inspect.Parameter.empty
                   for p in params.values()):
                b.flush()


def _captured_shapes(byid):
    return {k: (tuple(b.captured[0].shape)
                if getattr(b, "captured", None) else None)
            for k, b in byid.items() if not getattr(b, "out_ports", ())}


def main(argv=None):
    """CLI: python -m grtpu_torch.grc <run|generate> flowgraph.{json,yml,grc}
    [--steps N] [--set VAR=EXPR] [--device DEV]."""
    import argparse

    ap = argparse.ArgumentParser(prog="grtpu_torch.grc")
    ap.add_argument("action", choices=["run", "generate"])
    ap.add_argument("path")
    ap.add_argument("--steps", type=int, default=None,
                    help="override options.steps from the flowgraph file")
    ap.add_argument("--set", action="append", default=[], metavar="VAR=EXPR",
                    help="override a GRC variable/parameter (.grc only)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda)")
    args = ap.parse_args(argv)
    if args.path.endswith(".grc"):
        # the reference's own XML format (grc/python/Generator.py pipeline)
        from grtpu_torch.grc.grcxml import run_grc

        overrides = {}
        for kv in args.set:
            k, _, v = kv.partition("=")
            overrides[k] = eval(v)  # noqa: S307 - CLI-provided expression
        ex, byid = run_grc(args.path, steps=args.steps or 16,
                           overrides=overrides or None, device=args.device)
        print("flowgraph complete;", _captured_shapes(byid))
        return
    spec = load_flowgraph(args.path)
    if args.action == "generate":
        print(generate_script(spec, args.device))
        return
    from grtpu_torch.ops import cuda_fir
    from grtpu_torch.runtime.executor import StreamExecutor

    t0 = time.perf_counter()
    g, byid = spec.build()
    ex = StreamExecutor(g, chunk_size=spec.options.get("chunk_size", 4096),
                        device=args.device)
    steps = args.steps if args.steps is not None else \
        int(spec.options.get("steps", 16))
    before = dict(cuda_fir.launches)
    t1 = time.perf_counter()
    ex.run(steps=steps)
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    t2 = time.perf_counter()
    flush_sinks(byid)
    t3 = time.perf_counter()
    launched = {k: v - before.get(k, 0) for k, v in cuda_fir.launches.items()
                if v != before.get(k, 0)}
    print("flowgraph complete;", _captured_shapes(byid))
    print(f"on {ex.device}: build {t1 - t0:.3f} s (files read), run "
          f"{t2 - t1:.3f} s ({steps} steps), flush {t3 - t2:.3f} s; hand "
          f"kernel launches {launched}")
