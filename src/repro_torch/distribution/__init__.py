"""Distribution layer: sharding rules, pipeline parallelism, gradient
compression, mesh context, over `torch.distributed` process groups."""

from .sharding import (NamedSharding, PartitionSpec, batch_shardings,
                       cache_shardings, param_pspec, param_shardings,
                       placements, replicated, zero1_shardings)
from .pipeline import pipeline_apply, split_stages
from .compression import compressed_grad_sync, compressed_psum
from .context import current_mesh, with_mesh_context

__all__ = ["batch_shardings", "cache_shardings", "param_pspec",
           "param_shardings", "replicated", "zero1_shardings",
           "pipeline_apply", "split_stages", "compressed_grad_sync",
           "compressed_psum", "current_mesh", "with_mesh_context",
           "NamedSharding", "PartitionSpec", "placements"]
