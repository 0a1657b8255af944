"""The multi-device layer: a mesh of torch devices driven by one process
(:mod:`~grtpu_torch.parallel.mesh`), halo exchange, the sharded WBFM bank,
stage and tap pipelines, the time-sharded clock recovery, and the
multi-process ingest.  Port of ``grtpu.parallel``; the mesh executor is
:mod:`grtpu_torch.runtime.mesh_executor`."""
