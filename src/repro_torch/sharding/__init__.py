"""Distribution in the port: partition rules (:mod:`.specs`) and the
collectives of tensor-parallel serving (:mod:`.collectives`) — counterpart
of :mod:`repro.sharding`."""

from repro_torch.sharding import specs  # noqa: F401
from repro_torch.sharding.specs import (P, batch_specs, cache_specs, data_axes,
                                        opt_state_specs, param_specs)

__all__ = ["specs", "P", "batch_specs", "cache_specs", "data_axes", "opt_state_specs",
           "param_specs"]
