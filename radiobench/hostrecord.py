"""Where the harness's process runs on the host, and how near that is to
the card: a record for the result line's ``host`` object, so that a spread
between runs can be traced to where each run ran.

It reads the process's CPU affinity and ``/sys`` (the NUMA nodes of those
CPUs, the card's node by the PCI address CUDA reports) and changes
nothing.  What the machine does not show is None.
"""

from __future__ import annotations

import os
from pathlib import Path

SYS = Path("/sys")


def parse_cpulist(text: str) -> set:
    """The CPUs of a kernel CPU list such as ``0-3,8,10-11``."""
    cpus = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def _read(path: Path):
    try:
        return path.read_text().strip()
    except OSError:
        return None


def cpu_nodes(cpus: set, sys_root: Path = SYS):
    """The NUMA nodes that hold ``cpus``, or None where the machine shows
    no nodes."""
    nodes = {int(d.name[4:]) for d in (sys_root / "devices" / "system" / "node")
             .glob("node[0-9]*") if parse_cpulist(_read(d / "cpulist") or "") & cpus}
    return sorted(nodes) or None


def card(props, sys_root: Path = SYS) -> tuple:
    """(PCI address, NUMA node) of the card whose CUDA device properties are
    ``props``; None for what is not known (no card, no PCI ids, no node)."""
    ids = [getattr(props, f"pci_{k}_id", None) for k in ("domain", "bus", "device")]
    if None in ids:
        return None, None
    address = f"{ids[0]:04x}:{ids[1]:02x}:{ids[2]:02x}.0"
    node = _read(sys_root / "bus" / "pci" / "devices" / address / "numa_node")
    return address, (int(node) if node and int(node) >= 0 else None)


def describe(props=None, sys_root: Path = SYS) -> dict:
    """The CPUs this process may run on, their NUMA nodes, and the card
    (``props``: ``torch.cuda.get_device_properties``, None without a card)
    with its node."""
    allowed = os.sched_getaffinity(0)
    address, node = card(props, sys_root)
    return {"cpus_allowed": sorted(allowed), "cpu_nodes": cpu_nodes(allowed, sys_root),
            "card": address, "card_node": node}
