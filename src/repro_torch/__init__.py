"""repro_torch — Orpheus ported to PyTorch and CUDA on NVIDIA Hopper.

A second package beside :mod:`repro` (the JAX reference), mirroring its
layout module for module: GraphIR, the pass pipeline, backend policies,
``compile()`` -> ``Program``, an op registry where each op has several
interchangeable backends, and the Program-backed serving engine.  The
``cuda`` backends are hand-written CUDA C++ kernels for ``sm_90a``.

Importing ``repro_torch`` registers the standard ops (core.nnops) and the
kernel and serving ops (kernels.ops, kernels.serving_ops) in the port's
own registry.  It never imports ``jax`` or any module of ``repro``.
Entry points take ``device=None``, meaning ``"cuda"``; without a card they
raise unless the caller asks for ``device="cpu"``.
"""

from repro_torch import core  # noqa: F401  (registers standard ops)
from repro_torch.kernels import ops as _kernel_ops  # noqa: F401
from repro_torch.kernels import serving_ops as _serving_ops  # noqa: F401

__version__ = "0.1.0"
