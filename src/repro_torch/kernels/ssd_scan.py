"""Mamba-2 SSD chunked scan: (y, final state) from x, dt, A, B, C and an
optional initial state.

Replaces the Pallas kernel ``src/repro/kernels/ssd_scan.py:ssd_scan``
(``_ssd_kernel``), and covers ``nn/ssm.py:ssd_chunked`` whole (it takes
the initial state ``h0`` too). On a CUDA tensor :func:`ssd_scan`
launches ``csrc/ssd_scan.cu``, the chunk-parallel SSD on the TF32
tensor cores at fp32 accuracy (every operand split into TF32 hi and lo,
three MMAs a product): pass 1 computes every chunk's own state
contribution and, once per (batch, group, chunk), C·Bᵀ; pass 2 walks the
chunk states in order (the only sequential part; not launched where T
fits one chunk); pass 3 gives every chunk's output from its C·Bᵀ and the
state entering it. One call counts one launch on ``launches`` (its two or
three passes included). The chunk is ``SSD_CHUNK`` tokens; the heads a
block walks come from :func:`_plan`; the chunk states live in the
(device, stream)'s scratch buffer (``_build.scratch_slot``). On a CPU
tensor it runs :func:`repro_torch.kernels.ref.ssd_chunked`. Bound on the
H100: see the source's note.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ._build import H100_SMS as _H100_SMS
from ._build import (LaunchCounter, check_aligned, check_no_grad,
                     check_operand, grown_scratch, launch, scratch_slot,
                     sm_count)

launches = LaunchCounter()
plain = ref.ssd_chunked

# The chunk the kernel is built for (csrc/ssd_scan.cu's tile: L tokens, a
# block of passes 1 and 3 being L / 16 warps; 128 read slower than 64 at
# every SSD case on the H100, its pass 3 one block an SM against two:
# PERF.md §7), the most heads a block of passes 1 and 3 walks, and the
# columns of P it owns: the one table (kernels/_build.py writes it into
# the header the source includes).
SSD_CHUNK = 64
SSD_HEADS = 8
SSD_PT = 32
SM_SMEM = 228 * 1024            # an SM's, 1 KB of it reserved a block


def smem_bytes(N: int) -> tuple[int, int]:
    """Shared memory of a block of pass 1 and of pass 3 at state width N
    (csrc/ssd_scan.cu ``smem_pass1``, ``smem_pass3``, which the library
    reports as ``repro_ssd_smem_bytes``; a card test holds the two
    equal)."""
    L, ps = SSD_CHUNK, SSD_PT + 4
    p1 = 4 * max(L * (N + 8) + 2 * L * ps + SSD_HEADS * L + SSD_HEADS,
                 2 * L * 68)
    p3 = 4 * (L * (L + 4) + 3 * SSD_HEADS * L + 2 * L * ps + 2 * N * ps
              + L * (N + 4))
    return p1, p3


def scratch_floats(Bt: int, T: int, H: int, G: int, N: int, P: int) -> int:
    """Floats of the scratch a launch uses: the chunk states (Bt, nc, H,
    N, P) where there is more than one chunk, cs (Bt, nc, H, L) and C·Bᵀ
    (Bt, nc, G, L, L), L = ``SSD_CHUNK``."""
    L = SSD_CHUNK
    nc = -(-T // L)
    states = Bt * nc * H * N * P if nc > 1 else 0
    return states + Bt * nc * H * L + Bt * nc * G * L * L


def resident(N: int) -> int:
    """Blocks of pass 3 an SM holds at once, by shared memory."""
    return max(1, SM_SMEM // (smem_bytes(N)[1] + 1024))


@functools.lru_cache(maxsize=1024)
def _plan(Bt: int, T: int, H: int, P: int, G: int, N: int,
          sms: int = _H100_SMS) -> int:
    """The heads (of one group) a block of passes 1 and 3 walks, for
    (Bt, T) tokens of H heads of width P over G groups of state width N,
    on a card of ``sms`` SMs: of 1 to ``SSD_HEADS``, the one that
    minimises pass 3's waves over the card (its blocks, batch x chunks x
    head tiles x P tiles, over ``resident`` x ``sms``) times a block's
    time, counted as one head's work for its staging plus one a head (a
    block stages C and C·Bᵀ once for all its heads); ties to the fewest
    heads; then evened out over the group's head tiles (none empty)."""
    rep = H // G
    per_tile = Bt * -(-T // SSD_CHUNK) * G * -(-P // SSD_PT)
    slots = resident(N) * sms

    def cost(ht):
        return -(-per_tile * -(-rep // ht) // slots) * (1 + ht)

    heads = min(range(1, min(SSD_HEADS, rep) + 1), key=lambda ht: (
        cost(ht), ht))
    return -(-rep // -(-rep // heads))


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
        check_aligned("h0", h0)
    for name, t in (("x", x), ("B", B), ("C", C)):
        check_aligned(name, t)
    y = torch.empty_like(x)
    s = torch.empty((Bt, H, N, P), dtype=torch.float32, device=dev)
    heads = _plan(Bt, T, H, P, G, N, sm_count(dev))
    slot = scratch_slot(dev, torch._C._cuda_getCurrentRawStream(dev.index))
    with slot[0]:
        scratch = grown_scratch(slot, scratch_floats(Bt, T, H, G, N, P),
                                dev)
        launch("repro_ssd_scan_f32", dev, x.data_ptr(), dt.data_ptr(),
               A.data_ptr(), B.data_ptr(), C.data_ptr(),
               h0.data_ptr() if h0 is not None else None, y.data_ptr(),
               s.data_ptr(), scratch.data_ptr(), Bt, T, H, G, N, P, heads)
    launches.add()
    return y, s
