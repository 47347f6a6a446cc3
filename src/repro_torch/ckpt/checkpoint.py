"""Checkpoints (a port of the JAX package's ``ckpt/checkpoint.py``).

Layout per step, the JAX package's::

    <dir>/step_<N>/
        manifest.json        # tree structure, shapes, dtypes, step, extras
        arrays.npz           # flat leaf name → full array

* **Flat naming** — a leaf's name is its tree path (dict keys, list
  indices) joined by ``|``, exactly as the JAX package's ``_flatten``
  names a nested dict, so a checkpoint written by either package
  restores into the other's tree of the same structure.
* **Atomic publish** — writes go to ``step_N.tmp`` then ``os.replace``
  → a crash mid-write can never corrupt the latest checkpoint.
* **Self-contained training state** — params, optimizer state, step and
  the data-loader cursor all live in one manifest, so kill → restart
  resumes bit-exact.

* **Elastic restore** — ``restore(..., shardings=...)`` lays every
  saved array out over a mesh (``tree_specs`` output, e.g. another mesh
  than the one it was saved from); ``save`` of a tree of
  ``ShardedTensor`` leaves writes the gathered arrays, so either
  package reads them.
* **Quantized weights** — a ``QTensor`` leaf is saved as the JAX
  package's pytree flattens it, its codes, scale and zero at
  ``<path>|0``, ``|1`` and ``|2`` (a sharded one gathered from its
  filter blocks first, bit-equal); ``restore`` rebuilds it from a
  ``QTensor`` template leaf (its bits, shape and packing).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.quant import QTensor
from ..tree import flatten_with_path, map_with_path

SEP = "|"


def _key(path: tuple) -> str:
    return SEP.join(str(k) for k in path)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


_QPARTS = ("q", "scale", "zero")       # a QTensor's children, in order


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in flatten_with_path(tree):
        if hasattr(leaf, "shards"):         # a ShardedTensor: whole
            leaf = leaf.gather()
        if isinstance(leaf, QTensor):
            for i, part in enumerate(_QPARTS):
                out[_key(path + (i,))] = _numpy(getattr(leaf, part))
        else:
            out[_key(path)] = _numpy(leaf)
    return out


def _structure(tree: Any) -> str:
    """The tree's structure, leaves as ``*`` (keys sorted)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extras: dict | None = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = _flatten(tree)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": int(step),
        "treedef": f"PyTreeDef({_structure(tree)})",
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extras": extras or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def restore(ckpt_dir: str | Path, template: Any, step: int | None = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into ``template``'s tree structure: each leaf (a tensor, or
    anything with ``shape`` and ``dtype``, ``meta`` stand-ins included)
    is replaced by the saved array of its path, cast to its dtype, on its
    device (a tensor's; the CPU otherwise). With ``shardings`` (a tree of
    ``NamedSharding`` of the template's structure, ``tree_specs``'
    output), each array is instead laid out over its mesh's positions by
    ``sharding.shard_tensor``: a ``ShardedTensor``. Returns (tree, the
    manifest's extras and ``step``)."""
    if shardings is not None:
        from ..dist.sharding import shard_tensor
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as arrays:
        def array(path, tmpl):
            key = _key(path)
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(tmpl.shape)}")
            return torch.from_numpy(arr.astype(_numpy_dtype(tmpl.dtype)))

        def leaf(path, tmpl):
            if isinstance(tmpl, QTensor):
                arr = dataclasses.replace(tmpl, **{
                    part: array(path + (i,), getattr(tmpl, part))
                    for i, part in enumerate(_QPARTS)})
            else:
                arr = array(path, tmpl)
            if shardings is not None:
                return shard_tensor(arr, _at(shardings, path))
            device = tmpl.q.device if isinstance(tmpl, QTensor) else \
                tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            return arr.to(device)

        tree = map_with_path(leaf, template)
    return tree, manifest["extras"] | {"step": manifest["step"]}
