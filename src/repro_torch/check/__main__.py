"""CLI: compile builder models with the port and run the design-rule
checker (copied from the JAX package's ``repro/check/__main__.py``).

``python -m repro_torch.check --model yolov8n --bits mixed`` — compile
one builder at one wordlength mode and print every finding; ``--all``
sweeps every committed builder over float / w8a16 / mixed; ``--selftest``
runs the mutation self-test instead. ``--device`` is the FPGA the DSE
targets; the executor runs on ``cuda:0`` unless ``--torch-device cpu``
is given. Exit status 1 on any error-severity finding (or selftest
escape).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core import check as check_lib
from ..core import compile as compile_fn
from ..core.toolflow import CompileConfig
from ..models import yolo
from ..roofline.hw import FPGA_DEVICES, ZCU104

DEFAULT_MODELS = ("yolov3-tiny", "yolov5n", "yolov8n")
BITS_MODES = ("float", "w8a16", "mixed")


def _config(bits: str, device) -> CompileConfig:
    # check="warn": the CLI reports findings itself (and exits nonzero
    # on errors) instead of dying inside compile() on the first design.
    common = dict(device=device, check="warn", accuracy_probe=False)
    if bits == "float":
        return CompileConfig(**common)
    if bits == "w8a16":
        return CompileConfig(backend="quant", **common)
    # mixed: a small search budget — the CLI checks design legality,
    # it does not hunt the Pareto frontier.
    return CompileConfig(bits="mixed", search_evals=8, calib_frames=1,
                         **common)


def run_one(model: str, bits: str, img: int, device,
            torch_device=None) -> check_lib.CheckResult:
    m = yolo.build(model, img)
    acc = compile_fn(m, _config(bits, device), torch_device=torch_device)
    res = check_lib.check_accelerator(acc)
    return check_lib.CheckResult(graph=f"{model}@{bits}",
                                 findings=res.findings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="SATAY compile-time design-rule checker (PyTorch port)")
    ap.add_argument("--model", choices=sorted(yolo.YOLO_CONFIGS),
                    default="yolov8n")
    ap.add_argument("--bits", choices=BITS_MODES, default="float")
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--device", choices=sorted(FPGA_DEVICES),
                    default=ZCU104.name,
                    help="the FPGA the DSE targets")
    ap.add_argument("--torch-device", default=None,
                    help="where the executor runs (default cuda:0; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every committed builder over "
                         f"{'/'.join(BITS_MODES)}")
    ap.add_argument("--selftest", action="store_true",
                    help="mutation self-test: every SAT0xx code must "
                         "fire on its perturbation — zero escapes")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    device = FPGA_DEVICES[args.device]

    if args.selftest:
        try:
            results = check_lib.selftest(verbose=not args.as_json)
        except check_lib.CheckError as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(results, indent=2))
        else:
            print(f"selftest: {len(results)} diagnostic codes fired, "
                  f"zero escapes")
        return 0

    targets = [(m, b) for m in DEFAULT_MODELS for b in BITS_MODES] \
        if args.all else [(args.model, args.bits)]
    results = []
    n_err = 0
    for model, bits in targets:
        res = run_one(model, bits, args.img, device, args.torch_device)
        results.append(res)
        n_err += len(res.errors())
        if args.as_json:
            continue
        print(res.format())
    if args.as_json:
        print(json.dumps({r.graph: {
            "summary": r.summary(),
            "findings": [f.as_dict() for f in r.findings],
        } for r in results}, indent=2))
    else:
        print(f"{len(targets)} design(s) checked, {n_err} error(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
