"""Mamba-2 (SSD) mixer config.

Only the ``SsmCfg`` dataclass of the JAX package's ``nn/ssm.py`` is
here, copied verbatim: ``configs/registry.py`` and ``configs/base.py``
name it. The mixer and its chunked scan (kernel #13, ``ssd_scan``) are
not ported yet (ROADMAP.md, modules to port: the SSM/hybrid slice).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SsmCfg:
    d_model: int
    d_state: int = 128           # N
    head_dim: int = 64           # P
    expand: int = 2
    n_groups: int = 1            # G
    conv_kernel: int = 4
    chunk: int = 256
    act: str = "silu"            # kept SiLU: HardSwish would alter scan
                                 # dynamics (DESIGN.md §Arch-applicability)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim
