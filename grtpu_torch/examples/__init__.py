"""The example programs of grtpu on grtpu_torch (port of ``examples/``).

Each module runs as ``python -m grtpu_torch.examples.<name>``, takes the
options of its grtpu counterpart plus ``--device`` (the card unless named),
and prints the same lines.  See README.md in this directory.
"""
