"""Parallelism layer of the port — the counterpart of ``tpu_sdr/parallel/``:
meshes of shards, the halo exchange (plain copies and the K4/K5 CUDA
kernels), the sharded receive chains and the multi-process runtime.

Stations shard over ``dp``, time over ``sp`` with overlap-save halos
between neighbouring time shards, and a channel bank over its channel
blocks.  One process drives every device of its mesh, as one JAX
controller drives its mesh; ``distributed`` joins processes with
``torch.distributed`` when stations span hosts.
"""
