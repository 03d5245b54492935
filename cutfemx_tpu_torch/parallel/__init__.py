"""Distributed layer: slab meshes, owner-computes halo exchange, the
sharded pipelines and solvers — the torch counterpart of
``cutfemx_tpu.parallel``."""

from .operator import (make_device_mesh, pad_to_multiple,  # noqa: F401
                       shard_instances, sharded_matfree_operator,
                       sharded_cut_poisson_step)
from .halo import HaloOperator, build_slab_partition  # noqa: F401
from .spipeline import (ShardedCutProblem, SlabContext,  # noqa: F401
                        cut_poisson_builder)
