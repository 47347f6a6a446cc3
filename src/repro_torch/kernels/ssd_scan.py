"""Mamba-2 SSD chunked scan: (y, final state) from x, dt, A, B, C and an
optional initial state.

Replaces the Pallas kernel ``src/repro/kernels/ssd_scan.py:ssd_scan``
(``_ssd_kernel``), and covers ``nn/ssm.py:ssd_chunked`` whole (it takes
the initial state ``h0`` too). On a CUDA tensor :func:`ssd_scan`
launches ``csrc/ssd_scan.cu`` (one block per (batch, head, 16 columns
of P) looping over 64-token chunks with its slice of the state in
shared memory; see the source's note) and counts the launch on
``launches``; on a CPU tensor it runs
:func:`repro_torch.kernels.ref.ssd_chunked`. Bound on the H100:
operations (fp32 FMA).
"""
from __future__ import annotations

import torch

from . import ref
from ._build import (LaunchCounter, check_aligned, check_no_grad,
                     check_operand, launch)

launches = LaunchCounter()
plain = ref.ssd_chunked


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             h0: torch.Tensor | None = None) -> tuple:
    """x: (Bt, T, H, P); dt: (Bt, T, H); A: (H,); B, C: (Bt, T, G, N),
    head h reading group h // (H / G); h0: None or (Bt, H, N, P).
    Returns (y (Bt, T, H, P), final state (Bt, H, N, P)), float32. The
    kernel takes N a multiple of 16 up to 128 (every config's) and P a
    multiple of 16."""
    if not x.is_cuda:
        return plain(x, dt, A, B, C, h0=h0)
    check_no_grad(x, dt, A, B, C, h0)
    Bt, T, H, P = (int(d) for d in x.shape)
    G, N = int(B.shape[2]), int(B.shape[3])
    if G < 1 or H % G:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")
    if N % 16 or not 0 < N <= 128:
        raise ValueError(f"state width N={N}: the SSD kernel takes a "
                         f"multiple of 16 up to 128")
    if P % 16 or P <= 0:
        raise ValueError(f"head width P={P}: the SSD kernel takes a "
                         f"multiple of 16")
    dev = x.device
    check_operand("x", x, dev)
    check_operand("dt", dt, dev, (Bt, T, H))
    check_operand("A", A, dev, (H,))
    check_operand("B", B, dev, (Bt, T, G, N))
    check_operand("C", C, dev, (Bt, T, G, N))
    if h0 is not None:
        check_operand("h0", h0, dev, (Bt, H, N, P))
    for name, t in (("x", x), ("B", B), ("C", C)):
        check_aligned(name, t)
    y = torch.empty_like(x)
    s = torch.empty((Bt, H, N, P), dtype=torch.float32, device=dev)
    launch("repro_ssd_scan_f32", dev, x.data_ptr(), dt.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(),
           h0.data_ptr() if h0 is not None else None, y.data_ptr(),
           s.data_ptr(), Bt, T, H, G, N, P)
    launches.add()
    return y, s
