"""The flowgraph compiler: JSON / YAML specs and ``.grc`` XML files to
grtpu_torch graphs (port of ``grtpu.grc``).  ``python -m grtpu_torch.grc
run|generate <file> [--steps N] [--set VAR=EXPR] [--device DEV]``."""
from grtpu_torch.grc.flowgraph import FlowgraphSpec, generate_script, load_flowgraph
from grtpu_torch.grc.registry import BLOCK_REGISTRY, register_block
