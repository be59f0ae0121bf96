"""Channel mixers: SwiGLU (gated) and plain 2-matrix MLP — counterpart of
:mod:`repro.layers.mlp`."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import dense, dense_init

Params = Dict[str, Any]


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, *,
                dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype=dtype),
        "w_up": dense_init(gen, d, d_ff, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d, dtype=dtype),
    }


def swiglu_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig) -> torch.Tensor:
    b = cfg.backend("dense")
    g = dense(x, p["w_gate"], backend=b)
    u = dense(x, p["w_up"], backend=b)
    h = kops.swiglu(g, u, backend=cfg.backend("swiglu"))
    return dense(h, p["w_down"], backend=b)


def mlp_init(gen: torch.Generator, d: int, d_ff: int, *,
             dtype: torch.dtype = torch.float32) -> Params:
    return {
        "w_in": dense_init(gen, d, d_ff, dtype=dtype),
        "w_out": dense_init(gen, d_ff, d, dtype=dtype),
    }


def mlp_apply(p: Params, x: torch.Tensor, *, cfg: ArchConfig) -> torch.Tensor:
    b = cfg.backend("dense")
    h = dense(x, p["w_in"], backend=b)
    if cfg.act == "relu":
        h = torch.clamp(h, min=0)
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default form
    else:
        h = F.silu(h)
    return dense(h, p["w_out"], backend=b)
