"""Building blocks that mirror flax's mixed-precision layers.

flax ``nn.Dense(dtype=bf16)`` keeps fp32 parameters and casts the input and
the parameters to bf16 where they are used; flax ``nn.LayerNorm`` (eps 1e-6)
computes and returns fp32 whatever comes in.  The port mirrors both with
these two modules instead of ``torch.autocast``, so that a bf16 run rounds
where the JAX package rounds.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def normal_(t: torch.Tensor, std: float, generator) -> None:
    """Fill with N(0, std²) drawn on the CPU from ``generator``, so that a
    seed gives the same weights on every device."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator,
                            dtype=torch.float32) * std)


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    def init_weights(self, generator) -> None:
        """LeCun-normal weight, zero bias (flax ``nn.Dense``'s defaults)."""
        normal_(self.weight, 1.0 / math.sqrt(self.in_features), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed and returned in fp32, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)

    def init_weights(self, generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation of every submodule that defines
    ``init_weights(generator)`` for its own parameters, in registration
    order."""
    for m in module.modules():
        fn = getattr(type(m), "init_weights", None)
        if fn is not None:
            fn(m, generator)


def compute_dtype(name: str | None) -> torch.dtype:
    """``Config.compute_dtype`` as a torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if not name:
        return torch.float32
    if name not in table:
        raise ValueError(f"unknown compute_dtype {name!r}; expected one of "
                         f"{sorted(table)}")
    return table[name]
