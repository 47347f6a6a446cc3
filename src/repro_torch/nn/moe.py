"""Mixture-of-Experts layer (top-k routing, capacity-bounded, static shapes).

A torch port of the JAX package's ``nn/moe.py``: tokens are routed
(:func:`route`: router logits → softmax → top-k → gates normalised to
sum 1), packed by a stable sort over their expert ids into ``capacity``
slots per expert (one dump slot, E·C, takes the overflow), run through
grouped expert contractions (:func:`experts`, ``torch.bmm`` over the
expert axis: a plain product that the JAX package also computes outside
any Pallas kernel), and combined with their gates; an overflowing
assignment is dropped (weight 0), GShard/Switch semantics. The combine
gathers each token's K contributions back into (N, K, d) by the inverse
of the sort and sums them, so it is deterministic on the card (no
atomics, unlike ``index_add_``). No host sync: nothing is read back.

Covers both MoE configs: llama4-maverick (128 experts, top-1, one shared
expert) and qwen3-moe (128 experts, top-8, fine-grained d_ff).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ref
from . import layers as L


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


def init(gen: torch.Generator, cfg: MoeCfg, lead=(), device=None,
         dtype=torch.float32) -> dict:
    """The JAX package's tree and distributions. The experts' (E, d, f)
    weights take E as their fan-in, as ``layers.fan_in_init`` reads the
    JAX package's (its first axis)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "router": L.linear_init(gen, d, E, **kw),
        "w_gate": L.fan_in_init(gen, (E, d, f), **kw),
        "w_up": L.fan_in_init(gen, (E, d, f), **kw),
        "w_down": L.fan_in_init(gen, (E, f, d), **kw),
    }
    if cfg.n_shared:
        sf = cfg.shared_d_ff or f
        p["shared"] = L.mlp_init(gen, d, cfg.n_shared * sf, **kw)
    return p


def capacity(n_tokens: int, cfg: MoeCfg) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens (B·T of that
    call), padded to a multiple of 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p: dict, cfg: MoeCfg, xt: torch.Tensor):
    """xt: (N, d) → (probs (N, E), gate (N, K), idx (N, K)): the router's
    softmax, its top-k experts and their gates normalised to sum 1."""
    logits = L.linear(p["router"], xt).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate, idx


def experts(p: dict, cfg: MoeCfg, expert_in: torch.Tensor) -> torch.Tensor:
    """The grouped expert MLP: (E, C, d) → (E, C, d)."""
    dt = expert_in.dtype
    g = torch.bmm(expert_in, p["w_gate"].to(dt))
    u = torch.bmm(expert_in, p["w_up"].to(dt))
    h = ref.activation(cfg.act)(g) * u
    return torch.bmm(h, p["w_down"].to(dt))


def forward(p: dict, cfg: MoeCfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d) → (B, T, d). Aux losses: :func:`forward_with_aux`."""
    y, _ = forward_with_aux(p, cfg, x)
    return y


def forward_with_aux(p: dict, cfg: MoeCfg, x: torch.Tensor):
    """x: (B, T, d) → (y (B, T, d), {"load_balance", "dropped_frac"}),
    both 0-d tensors on x's device. Routing goes through the module's
    :func:`route`."""
    B, T, d = x.shape
    N = B * T
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(N, cfg)
    xt = x.reshape(N, d)
    dev = x.device
    probs, gate, idx = route(p, cfg, xt)

    # ---- pack: stable sort (token·K assignments) by expert id ----------
    flat_e = idx.reshape(-1)                                   # (N*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # position within its expert group = rank - first rank of the expert
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                               side="left")
    pos_in_e = torch.arange(N * K, device=dev) - first[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)   # dump slot
    tok_of_assign = order // K
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[tok_of_assign]
    expert_out = experts(p, cfg, buf[:E * C].reshape(E, C, d))

    # ---- combine: each token's K contributions, summed in k order ------
    out_flat = torch.cat([expert_out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=x.dtype, device=dev)])
    w = gate.reshape(-1)[order] * keep                         # (N*K,)
    contrib = out_flat[slot] * w[:, None].to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * K, device=dev)
    y = contrib[inv].reshape(N, K, d).sum(dim=1)

    if "shared" in p:
        y = y + L.mlp(p["shared"], xt, act=cfg.act)

    # Switch-style load-balance aux loss.
    me = torch.nn.functional.one_hot(idx[:, 0], E).to(torch.float32).mean(0)
    ce = probs.mean(dim=0)
    aux = {"load_balance": E * torch.sum(me * ce),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    return y.reshape(B, T, d), aux
