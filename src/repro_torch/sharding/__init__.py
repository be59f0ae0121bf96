"""Distribution in the port: partition rules and the slicing of trees by
them (:mod:`.specs`) and the collectives of tensor-parallel serving and
sharded training (:mod:`.collectives`) — counterpart of
:mod:`repro.sharding`."""

from repro_torch.sharding import specs  # noqa: F401
from repro_torch.sharding.specs import (P, batch_specs, cache_specs, data_axes, gather_tree,
                                        opt_state_specs, param_specs, shard_tree)

__all__ = ["specs", "P", "batch_specs", "cache_specs", "data_axes", "opt_state_specs",
           "param_specs", "shard_tree", "gather_tree"]
