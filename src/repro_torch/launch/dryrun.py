"""Multi-pod dry run: lay out every (arch × shape × mesh) cell, allocating
nothing (a port of the JAX package's ``launch/dryrun.py``).

For each cell this module:
  1. builds the production mesh (16×16 single-pod / 2×16×16 multi-pod)
     with no devices bound (``launch.mesh.make_production_mesh``),
  2. builds the cell's parameter, optimizer-state, input and cache trees
     on the ``meta`` device (``steps.param_specs``, ``input_specs``,
     ``cache_specs_shapes``) and lays them out by
     ``dist.sharding.plan_for`` (``tree_specs``; the batch over the data
     axes, on axis 1 of a microbatch-shaped train batch; the cache by
     ``dist.spmd.cache_rules``),
  3. records ``memory.per_position``: the bytes of each kind at a
     position, from the shard shapes (every position's blocks have one
     size) — the counterpart of ``memory_analysis()``'s argument bytes,
  4. records the analytic memory, rooflines (``roofline.analysis`` on
     ``hw.H100_SXM``, float32: ``param_bytes=4``), ``model_flops`` and
     the parameter counts,
  5. writes one JSON per cell under ``--out``.

Lowering and compiling have no counterpart: the port runs eagerly, so
``compile_s``, ``hlo`` and ``roofline_hlo`` are None, and
``--no-compile`` changes nothing.

The JAX module reads seven names that ``repro/dist/sharding.py`` never
defines (``plan_for_opt``, ``dp_axes``, ``axis_size``, ``batch_specs``,
``optimizer_for``, ``cache_specs``, ``sanitize_specs``) and four fields
that its ``ShardingPlan`` lacks (``microbatches``, ``grad_dtype``,
``shard_experts``, ``dp_over_model``), so it raises before it records a
cell. Where it reads them, this port takes the value that the JAX
code's own defaults imply:

* the data axes: every axis but ``model`` (``spmd.data_axes``);
* microbatches: 1 (the train step's default ``n_microbatches``);
* gradient dtype: float32 (``make_train_step``'s ``accum_dtype``);
* optimizer: ``adamw`` (``analytic_memory_per_chip``'s default);
* ``shard_experts``: True and ``dp_over_model``: False
  (``analytic_collective_bytes``' defaults);
* a dimension that does not divide its mesh axes: not sharded
  (``_guard``, for ``sanitize_specs``).

``--opt`` (the optimized plans of ``plan_for_opt``) raises
``NotImplementedError``: the reference never defines them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import registry
from ..configs.base import ALL_SHAPES, SHAPES, ModelCfg, ShapeCell
from ..dist import sharding as sh
from ..dist import spmd
from ..optim import optimizers as opt_lib
from ..roofline import analysis as ra
from ..roofline.hw import DEFAULT_CHIP
from ..tree import flatten_with_path
from . import mesh as mesh_lib
from . import steps

MICROBATCHES = 1
GRAD_DTYPE = "float32"
OPTIMIZER = "adamw"
PARAM_BYTES = 4


def _mesh_desc(mesh) -> dict:
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def skip_reason(cfg: ModelCfg, cell: ShapeCell) -> str | None:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (DESIGN.md "
                "§Arch-applicability)")
    return None


def _specs(by_path: dict, spec_of, mesh) -> dict:
    """``NamedSharding`` of each stand-in (by path): ``spec_of(path,
    leaf)`` guarded."""
    return {path: sh.NamedSharding(mesh, sh._guard(
        tuple(leaf.shape), spec_of(path, leaf), mesh))
        for path, leaf in by_path.items()}


def _tree_sharding(shapes, mesh, plan) -> dict:
    return dict(flatten_with_path(sh.tree_specs(shapes, mesh, plan)))


def _block_bytes(leaf, sharding) -> int:
    """The bytes of one position's block of ``leaf``: ``_guard`` keeps
    only axes that divide their dimension, so every position's block
    has this size."""
    n = 1
    for i, d in enumerate(leaf.shape):
        ax = sharding.spec[i] if i < len(sharding.spec) else None
        div = 1 if ax is None else math.prod(
            int(sharding.mesh.shape[a]) for a in sh._axes(ax))
        n *= d // div
    return n * leaf.element_size()


def per_position_bytes(kinds: dict) -> dict:
    """``kinds``: name → (stand-ins by path, shardings by path). The
    bytes of each kind at one position, and their ``total``."""
    out = {k: sum(_block_bytes(leaf, specs[path])
                  for path, leaf in shapes.items())
           for k, (shapes, specs) in kinds.items()}
    out["total"] = sum(out.values())
    return out


def lower_cell(cfg: ModelCfg, cell: ShapeCell, mesh, *,
               compile_: bool = True, opt: bool = False) -> dict:
    """Lay out one cell on one mesh; return the record."""
    if opt:
        raise NotImplementedError(
            "--opt reads sharding.plan_for_opt, which the JAX package "
            "never defines (ROADMAP.md §3)")
    chips = math.prod(int(mesh.shape[a]) for a in mesh.axis_names)
    rec: dict = {"arch": cfg.name, "cell": cell.name, "kind": cell.kind,
                 "mesh": _mesh_desc(mesh), "chips": chips}
    t0 = time.time()
    plan = sh.plan_for(cfg)
    dpa = spmd.data_spec(mesh)
    dp = math.prod(int(mesh.shape[a]) for a in spmd.data_axes(mesh))
    n_mb = max(1, min(MICROBATCHES, cell.global_batch // dp)) \
        if cell.kind == "train" else 1
    pshapes = steps.param_specs(cfg)
    kinds = {"params": (dict(flatten_with_path(pshapes)),
                        _tree_sharding(pshapes, mesh, plan))}
    in_spec = dict(flatten_with_path(steps.input_specs(
        cfg, cell, n_microbatches=n_mb)))
    if cell.kind == "train":
        rec["microbatches"] = n_mb
        rec["optimizer"] = OPTIMIZER
        rec["grad_dtype"] = GRAD_DTYPE
        oshapes = opt_lib.get(OPTIMIZER).init(pshapes)
        kinds["opt_state"] = (dict(flatten_with_path(oshapes)),
                              _tree_sharding(oshapes, mesh, plan))
        kinds["grads"] = kinds["params"]          # float32, the same layout
        kinds["inputs"] = (in_spec, _specs(
            in_spec, lambda path, v: (None, dpa)
            + (None,) * (v.ndim - 2), mesh))
    else:
        kinds["inputs"] = (in_spec, _specs(
            in_spec, lambda path, v: (dpa,) + (None,) * (v.ndim - 1), mesh))
        cshapes = dict(flatten_with_path(steps.cache_specs_shapes(cfg, cell)))
        rules = spmd.cache_rules(mesh)
        kv = rules["k"]
        kinds["cache"] = (cshapes, _specs(
            cshapes, lambda path, v: rules.get(path[0], kv[:v.ndim]), mesh))
        lshape = {("logits",): torch.empty(
            (cell.global_batch, cfg.vocab), dtype=steps.ACT_DTYPE,
            device=steps.META)}
        kinds["logits"] = (lshape, _specs(
            lshape, lambda path, v: (dpa, "model"), mesh))
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["compile_s"] = None

    per_pos = per_position_bytes(kinds)
    amem = ra.analytic_memory_per_chip(
        cfg, cell, _mesh_desc(mesh), rec.get("microbatches", 1),
        rec.get("optimizer", OPTIMIZER), param_bytes=PARAM_BYTES,
        grad_bytes=4)
    rec["memory"] = {
        "per_position": per_pos,
        "analytic_per_chip": amem,
        "fits_hbm_analytic": amem["total"] < DEFAULT_CHIP.hbm_bytes,
        "fits_hbm_per_position": per_pos["total"] < DEFAULT_CHIP.hbm_bytes,
        "hbm_bytes": DEFAULT_CHIP.hbm_bytes,
    }
    rec["hlo"] = None

    n_mb = rec.get("microbatches", 1)
    af = ra.analytic_flops(cfg, cell)
    ab = ra.analytic_bytes(cfg, cell, n_mb, param_bytes=PARAM_BYTES)
    ac = ra.analytic_collective_bytes(cfg, cell, _mesh_desc(mesh), n_mb,
                                      param_bytes=PARAM_BYTES,
                                      shard_experts=True, tp_active=True)
    mf = ra.model_flops(cfg, cell)
    # compute-effective chips: the SSM mixer cannot TP under the default
    # plan — the model axis idles for its FLOPs.
    eff = dp if cfg.family == "ssm" else chips
    rec["compute_chips_effective"] = eff
    ana_roof = ra.Roofline(af["total"], ab, ac, chips, compute_chips=eff)
    rec["roofline_hlo"] = None
    rec["roofline_analytic"] = ana_roof.as_dict()
    rec["model_flops"] = mf
    rec["flops_ratio_model_over_analytic"] = (mf / af["total"]
                                              if af["total"] else None)
    rec["params"] = cfg.param_count()
    rec["params_active"] = cfg.param_count(active_only=True)
    return rec


def run(arch: str, shape: str, mesh_kind: str, out_dir: str,
        compile_: bool = True, opt: bool = False) -> list[dict]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    archs = list(registry.ARCHS) if arch == "all" else [arch]
    cells = list(ALL_SHAPES) if shape == "all" else [SHAPES[shape]]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[mesh_kind]
    results = []
    for a in archs:
        cfg = registry.get(a)
        for cell in cells:
            for mp in meshes:
                tag = (f"{a}__{cell.name}__{'multi' if mp else 'single'}"
                       + ("__opt" if opt else ""))
                fp = out / f"{tag}.json"
                reason = skip_reason(cfg, cell)
                if reason:
                    rec = {"arch": a, "cell": cell.name, "skipped": reason,
                           "mesh": "multi" if mp else "single"}
                    fp.write_text(json.dumps(rec, indent=1))
                    print(f"[SKIP] {tag}: {reason}")
                    results.append(rec)
                    continue
                try:
                    mesh = mesh_lib.make_production_mesh(multi_pod=mp)
                    rec = lower_cell(cfg, cell, mesh, compile_=compile_,
                                     opt=opt)
                    rec["status"] = "ok"
                    rec["optimized"] = opt
                    mem = rec["memory"]
                    dom = rec["roofline_analytic"]["bottleneck"]
                    print(f"[OK]   {tag}: lower={rec['lower_s']}s "
                          f"per-position="
                          f"{mem['per_position']['total'] / 2**30:.2f}GiB "
                          f"analytic/chip="
                          f"{mem['analytic_per_chip']['total'] / 2**30:.2f}"
                          f"GiB bound={dom}", flush=True)
                except NotImplementedError:
                    raise
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": a, "cell": cell.name,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {e!r}")
                fp.write_text(json.dumps(rec, indent=1, default=str))
                results.append(rec)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-compile", action="store_true",
                    help="lower only (the port compiles nothing: no effect)")
    ap.add_argument("--opt", action="store_true",
                    help="the optimized plans (not defined by the JAX "
                         "package: raises NotImplementedError)")
    args = ap.parse_args(argv)
    results = run(args.arch, args.shape, args.mesh, args.out,
                  compile_=not args.no_compile, opt=args.opt)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum("skipped" in r for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"of {len(results)}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
