"""Mixture-of-Experts config.

Only the ``MoeCfg`` dataclass of the JAX package's ``nn/moe.py`` is
here, copied verbatim: ``configs/registry.py`` and ``configs/base.py``
name it. The MoE layer itself (routing, capacity slots, grouped expert
matmuls) is not ported yet (ROADMAP.md, modules to port: moe/vlm/encdec).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared: int = 0              # always-on shared experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"
