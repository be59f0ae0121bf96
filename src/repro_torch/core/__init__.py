"""Core of the port: GraphIR, backend registry, pass pipeline and the
compiled Program (counterpart of :mod:`repro.core`).

OXF bundles (:mod:`repro_torch.core.importer`) cross between the
packages: ``Program.save`` writes the format's backend names and
``load_program`` maps them to the port's.

Importing this package registers the port's standard ops
(:mod:`repro_torch.core.nnops`), the quantized ops and the ``quantize``
pass (:mod:`repro_torch.core.quant`) and the passes
(:mod:`repro_torch.core.passes`).

    graph --PassManager--> simplified graph --BackendPolicy--> Program
"""

from repro_torch.core import nnops as _nnops  # noqa: F401  (registers standard ops)
from repro_torch.core.device import resolve_device, to_tensor
from repro_torch.core.executor import Executor
from repro_torch.core.importer import load_graph, load_program, save_graph
from repro_torch.core.ir import Graph, GraphError, Node, TensorSpec, topological_order
from repro_torch.core.passes import (eliminate_common_subexpr, eliminate_dead,
                                     fold_batchnorm, fold_constants, fuse_bias_act,
                                     fuse_elementwise, infer_shapes, simplify)
from repro_torch.core.pipeline import (DEFAULT_PASSES, PassManager, PassStats,
                                       PipelineError, default_pipeline, get_pass,
                                       register_pass, registered_passes)
from repro_torch.core.program import NodeReport, Program, compile
from repro_torch.core.quant import (ValueRange, calibrate, is_quantized, quantize_graph,
                                    quantize_weight)
from repro_torch.core.registry import (Cost, OpDef, OpImpl, backends_for, defop,
                                       get_impl, get_op, impl, registered_ops)
from repro_torch.core.selector import (H100_SXM, HOST_CPU, AutotunePolicy, BackendPolicy,
                                       CostModelPolicy, FixedPolicy, HardwareProfile,
                                       default_cache_path, hardware_fingerprint)

__all__ = [
    "compile", "Program", "NodeReport", "Executor",
    "load_graph", "load_program", "save_graph",
    "calibrate", "quantize_graph", "quantize_weight", "is_quantized", "ValueRange",
    "Graph", "GraphError", "Node", "TensorSpec", "topological_order",
    "eliminate_common_subexpr", "eliminate_dead", "fold_batchnorm", "fold_constants",
    "fuse_bias_act", "fuse_elementwise", "infer_shapes", "simplify",
    "DEFAULT_PASSES", "PassManager", "PassStats", "PipelineError",
    "default_pipeline", "get_pass", "register_pass", "registered_passes",
    "Cost", "OpDef", "OpImpl", "backends_for", "defop", "get_impl", "get_op",
    "impl", "registered_ops",
    "BackendPolicy", "FixedPolicy", "CostModelPolicy", "AutotunePolicy",
    "HardwareProfile", "H100_SXM", "HOST_CPU", "hardware_fingerprint",
    "default_cache_path",
    "resolve_device", "to_tensor",
]
