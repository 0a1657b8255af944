"""Child process of the two-process test in tests/test_torch_parallel.py.

Usage: python _torch_multihost_child.py RANK WORLD PORT OUTDIR

Each process owns 4 entries (all ``cpu``) of a global 8-entry ``chan``
mesh, ingests ITS slice of the global stream with ``feed_from_host``, and
runs one step whose normalization is a psum across the process boundary
(gloo), then a ring ppermute and an all_gather over ``chan``.  Its local
results go to OUTDIR/mh_<rank>.npz for the parent to check.  Imports
torch and grtpu_torch only; it ends within its own time limit.
"""

import os
import signal
import sys

signal.alarm(90)          # the child's own time limit

rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from grtpu_torch.ops.fir import fir_filter  # noqa: E402
from grtpu_torch.parallel import mesh as tm  # noqa: E402
from grtpu_torch.parallel.multihost import (feed_from_host,  # noqa: E402
                                            host_shard_spec, init_distributed)

init_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")

NCHAN, NSAMP, K = 8, 512, 16
taps = (np.arange(1, K + 1) / (K * K)).astype(np.float32)
full = np.sin(np.arange(NCHAN * (NSAMP + K - 1), dtype=np.float32)
              .reshape(NCHAN, NSAMP + K - 1) * 0.01)

mesh = tm.Mesh(np.array(["cpu"] * NCHAN, dtype=object), ("chan",),
               processes=np.repeat(np.arange(world), NCHAN // world))
spec = tm.P("chan")
sl = host_shard_spec(mesh, spec, full.shape)
assert sl[0].stop - sl[0].start == NCHAN // world, sl
parts = feed_from_host(mesh, spec, full[sl], full.shape)

# per-channel FIR (the halo is in the input), then normalize by the global
# mean power: the sum crosses the processes
y = tm.local_map(lambda r: fir_filter(r, taps), mesh, parts)
total = tm.psum(tm.local_map(lambda v: torch.sum(v * v), mesh, y), mesh,
                "chan")
y = tm.local_map(lambda v, p: v / torch.sqrt(p / (NCHAN * NSAMP) + 1e-9),
                 mesh, y, total)
firsts = tm.local_map(lambda r: r[:, 0], mesh, parts)
ring = [(i, (i + 1) % NCHAN) for i in range(NCHAN)]
perm = tm.ppermute(firsts, mesh, "chan", ring)
gathered = tm.all_gather(firsts, mesh, "chan")

mine = [idx for idx in mesh.entries() if mesh.is_local(idx)]
np.savez(os.path.join(outdir, f"mh_{rank}.npz"),
         y=torch.cat([y[i] for i in mine]).numpy(),
         perm=torch.cat([perm[i] for i in mine]).numpy(),
         gathered=torch.stack([gathered[i][:, 0] for i in mine]).numpy())
torch.distributed.destroy_process_group()
print(f"pid{rank} OK jax_loaded={'jax' in sys.modules}", flush=True)
