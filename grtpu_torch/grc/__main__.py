"""``python -m grtpu_torch.grc run|generate <file>``: see
:func:`grtpu_torch.grc.flowgraph.main`."""

from grtpu_torch.grc.flowgraph import main

if __name__ == "__main__":
    main()
