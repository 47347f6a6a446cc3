"""Mamba-2 mixer (SSD, state-space duality).

A torch port of the JAX package's ``nn/ssm.py``: ``SsmCfg`` (verbatim),
``init``, ``_split_proj``, ``_causal_conv``, ``ssd_chunked``,
``forward``, ``decode_step`` and ``init_state``, over the JAX package's
parameter tree. Where the JAX package runs its XLA-native chunked scan
(the same function as its Pallas kernel), the port calls
``ops.ssd_scan``: the CUDA kernel (``csrc/ssd_scan.cu``) on the card,
its plain version on the CPU. B and C go to it per group, never
repeated per head. The depthwise causal conv and the one-token decode
recurrence stay plain tensor code, as in the JAX package; a decode step
writes the conv ring and the state into the cache IN PLACE.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from . import layers as L


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


def init(gen: torch.Generator, cfg: SsmCfg, lead=(), device=None,
         dtype=torch.float32) -> dict:
    """The JAX package's distributions: fan-in truncated normals for the
    projections, 0.2 for the conv taps; ``A_log = log(linspace(1, 16,
    H))`` (float32), ``D = 1``, ``dt_bias = 0``, ``conv_b = 0`` and the
    norm gain 0 are deterministic."""
    d, di, H, G, N = (cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.n_groups,
                      cfg.d_state)
    lead = tuple(lead)
    conv_dim = di + 2 * G * N
    kw = dict(lead=lead, device=device, dtype=dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=device))
    return {
        # fused in-proj: [z, x, B, C, dt]
        "in_proj": L.linear_init(gen, d, 2 * di + 2 * G * N + H, **kw),
        "conv_w": L.trunc_normal(gen, lead + (cfg.conv_kernel, conv_dim),
                                 std=0.2, device=device, dtype=dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype,
                              device=device),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), dtype=dtype, device=device),
        "dt_bias": torch.zeros(lead + (H,), dtype=dtype, device=device),
        "norm": L.rmsnorm_init(di, **kw),
        "out_proj": L.linear_init(gen, di, d, **kw),
    }


def _split_proj(cfg: SsmCfg, zxbcdt: torch.Tensor):
    di, G, N, H = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    return torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d, then SiLU. xBC: (B, T, C); w: (K, C).

    ``state``: (B, K-1, C) trailing inputs from the previous segment.
    Returns (out, new_state)."""
    Bz, T, Cc = xBC.shape
    K = w.shape[0]
    if state is None:
        state = xBC.new_zeros((Bz, K - 1, Cc))
    xp = torch.cat([state, xBC], dim=1)
    out = torch.zeros_like(xBC)
    for k in range(K):
        out = out + xp[:, k:k + T] * w[k][None, None, :]
    return ref.silu(out + b[None, None, :]), xp[:, T:]


def ssd_chunked(x, dt, A, Bm, Cm, h0=None, chunk: int = 256):
    """Chunked SSD. x: (B, T, H, P); dt: (B, T, H); A: (H,); Bm/Cm:
    (B, T, G, N) per group. Returns (y, final_state float32).

    T must be a multiple of ``min(chunk, T)``, as the JAX package asserts
    (``nn/ssm.py:98-99``), so that both refuse the same prompts; the
    kernel itself takes any T in its own 64-token chunks."""
    T = x.shape[1]
    c = min(chunk, T)
    assert T % c == 0, (T, c)
    return ops.ssd_scan(x, dt, A, Bm, Cm, h0=h0)


def _gate_out(p: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The mixer's RMSNorm (eps 1e-6), the SiLU(z) gate, out_proj."""
    return L.linear(p["out_proj"], L.rmsnorm(p["norm"], y) * ref.silu(z))


def forward(p: dict, cfg: SsmCfg, x: torch.Tensor,
            state: dict | None = None):
    """Full-sequence mixer. x: (B, T, d) → (B, T, d).

    ``state`` (decode handoff): {"conv": (B, K-1, C), "ssm": (B, H, N,
    P)}. Returns (y, new_state)."""
    Bz, T, _ = x.shape
    H, G, N, P = cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xBC, dt = _split_proj(cfg, L.linear(p["in_proj"], x))
    conv_state = state["conv"] if state else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xBC, [cfg.d_inner, G * N, G * N], dim=-1)
    xh = xs.reshape(Bz, T, H, P)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    h0 = state["ssm"] if state else None
    y, S_fin = ssd_chunked(xh, dt, A, Bm.reshape(Bz, T, G, N),
                           Cm.reshape(Bz, T, G, N), h0=h0, chunk=cfg.chunk)
    y = y + xh * p["D"][None, None, :, None]
    out = _gate_out(p, y.reshape(Bz, T, cfg.d_inner), z)
    return out, {"conv": new_conv, "ssm": S_fin}


def decode_step(p: dict, cfg: SsmCfg, x: torch.Tensor, state: dict):
    """Single-token recurrent step. x: (B, 1, d); state {"conv": (B, K-1,
    C), "ssm": (B, H, N, P)}, both updated IN PLACE (the JAX package
    returns new ones; the values are the same). Returns (y (B, 1, d),
    state)."""
    Bz = x.shape[0]
    H, G, N, P = cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    z, xBC, dt = _split_proj(cfg, L.linear(p["in_proj"], x))
    conv = state["conv"]
    xp = torch.cat([conv, xBC], dim=1)                         # (B, K, C)
    out = torch.einsum("bkc,kc->bc", xp, p["conv_w"]) + p["conv_b"]
    conv.copy_(xp[:, 1:])
    xs, Bm, Cm = torch.split(ref.silu(out), [cfg.d_inner, G * N, G * N],
                             dim=-1)
    xh = xs.reshape(Bz, H, P)
    rep = H // G
    Bm, Cm = Bm.reshape(Bz, G, N), Cm.reshape(Bz, G, N)
    if rep > 1:
        Bm = Bm.repeat_interleave(rep, dim=1)
        Cm = Cm.repeat_interleave(rep, dim=1)
    dt1 = F.softplus(dt.to(torch.float32)
                     + p["dt_bias"][None, None, :])[:, 0]      # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p["A_log"])[None, :])
    S = state["ssm"]
    S.mul_(decay[..., None, None]).add_(torch.einsum(
        "bhx,bhp->bhxp", Bm, dt1[..., None] * xh.to(torch.float32)))
    y = torch.einsum("bhx,bhxp->bhp", Cm.to(torch.float32), S)
    y = y.to(x.dtype) + xh * p["D"][None, :, None]
    return _gate_out(p, y.reshape(Bz, 1, cfg.d_inner), z), state


def init_state(cfg: SsmCfg, batch: int, dtype=torch.float32,
               device=None) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }
