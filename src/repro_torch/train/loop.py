"""Training loop: the eager step + checkpoint/restart + failure recovery
(a port of the JAX package's ``train/loop.py``).

* the step from ``launch/steps.py`` (microbatch accumulation, remat by
  ``cfg.remat``), run eagerly; capturing it in a CUDA graph is later
  work;
* checkpoint every ``ckpt_every`` steps through ``ckpt/checkpoint.py``
  (atomic publish); the loader cursor rides in the manifest, and a run
  with a checkpoint directory resumes from its newest checkpoint,
  bit-exact;
* retry-on-failure: a step that raises is retried from the last good
  state up to ``max_retries`` times — the step leaves its arguments as
  they were, and the data is a pure function of (seed, index), so the
  retry is exact.

Like the port's other entry points, the loop runs on the card
(``cuda:0``) unless ``device`` names another, and raises without CUDA.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable

import torch

from ..ckpt import checkpoint as ckpt_lib
from ..configs.base import ModelCfg
from ..data.synthetic import TokenStream
from ..device import resolve_device
from ..launch import steps as steps_lib
from ..models import lm
from ..optim import optimizers as opt_lib
from ..tree import leaves


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    lr: float = 3e-4
    warmup: int = 20
    optimizer: str = "adamw"
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    max_retries: int = 2


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def _optimizer(tc: TrainConfig) -> opt_lib.Optimizer:
    return opt_lib.get(tc.optimizer,
                       lr=opt_lib.warmup_cosine(tc.lr, tc.warmup, tc.steps))


def init_state(cfg: ModelCfg, tc: TrainConfig, dtype=torch.float32,
               device=None):
    """Fresh parameters (from ``tc.seed``) and optimizer state on
    ``device`` (default ``cuda:0``); returns (state, optimizer)."""
    device = resolve_device(device)
    opt = _optimizer(tc)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(
        tc.seed), device=device, dtype=dtype)
    return TrainState(params, opt.init(params), 0), opt


def train(cfg: ModelCfg, tc: TrainConfig, state: TrainState | None = None,
          hooks: Callable[[int, dict], None] | None = None,
          device=None) -> dict:
    """Run (or resume) a training job; returns the loss history and the
    final state. Without ``state``, a fresh one on ``device`` (default
    ``cuda:0``), or the newest checkpoint of ``tc.ckpt_dir`` restored
    into it; with one, its step and device."""
    opt = _optimizer(tc)
    cursor = None
    if state is None:
        state, _ = init_state(cfg, tc, device=device)
        if tc.ckpt_dir and ckpt_lib.latest_step(tc.ckpt_dir) is not None:
            tree = {"params": state.params, "opt": state.opt_state}
            tree, extras = ckpt_lib.restore(tc.ckpt_dir, tree)
            state = TrainState(tree["params"], tree["opt"], extras["step"])
            cursor = extras.get("loader_index")
    start_step = state.step
    index = start_step if cursor is None else cursor
    dev = leaves(state.params)[0].device

    stream = TokenStream(vocab=cfg.vocab, seq_len=tc.seq_len,
                         batch=tc.batch, seed=tc.seed,
                         microbatches=tc.microbatches)
    step_fn = steps_lib.make_train_step(cfg, opt, tc.microbatches)

    history: list[float] = []
    t0 = time.time()
    params, opt_state = state.params, state.opt_state
    i = start_step
    while i < tc.steps:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(index).items()}
        retries = 0
        while True:
            try:
                new_params, new_opt, metrics = step_fn(params, opt_state, i,
                                                       batch)
                break
            except RuntimeError as e:     # a device fault: retry the step
                retries += 1
                if retries > tc.max_retries:
                    raise
                print(f"step {i}: {e!r}; retry {retries} of "
                      f"{tc.max_retries}", file=sys.stderr, flush=True)
        params, opt_state = new_params, new_opt
        loss = float(metrics["loss"])
        history.append(loss)
        if hooks:
            hooks(i, {k: float(v) for k, v in metrics.items()})
        if tc.log_every and (i % tc.log_every == 0 or i == tc.steps - 1):
            dt = time.time() - t0
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        i += 1
        index += 1
        if tc.ckpt_dir and (i % tc.ckpt_every == 0 or i == tc.steps):
            ckpt_lib.save(tc.ckpt_dir, i,
                          {"params": params, "opt": opt_state},
                          extras={"loader_index": index})
    return {"loss_history": history,
            "final_state": TrainState(params, opt_state, i)}
