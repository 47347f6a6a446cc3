#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out FILE.json]

Phases, each printed as it runs; any failure raises and the script exits
non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, the TF32 flags (both forced off: the kernels and their
   plain versions compare in full float32), and the kernels' build from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) with its time.
2. Kernels: each CUDA kernel held against its plain PyTorch version on
   the card at shapes the compiled yolov8n at 640 gives it (batch 8;
   every conv case is checked to be a conv launch of that graph), with
   its time (CUDA events over back-to-back launches, after warm-up), the
   plain version's time, one PyTorch library call's time as a yardstick
   (never called by the port), and the bound: max(FLOPs / 67 TFLOP/s
   fp32, bytes / 3.35 TB/s), H100 SXM data-sheet peaks.
3. Two paths through the user's entry points, each with the launch
   counters set to 0 just before it and read just after:
   ``main``: yolov8n at 640 → ``core.compile`` → ``serve.Deployment``
   (2 replicas, batch 8) serving 32 requests; ``fusion_off``: the same
   entry points with the fusion passes off (yolov8n at 160,
   ``CompileConfig(passes=())``), where every activation, add, concat
   and split launches on its own. Launch counts are checked per forward,
   and every output against the same graph run through the plain
   versions (``backend="ref"``) on the card at atol = rtol = 1e-3 (63
   float32 convs, sums in another order).
4. Timing: a short serving window (a smoke reading, not a benchmark),
   the executor forward, and the spans of one replica step run alone
   (assemble, issue, wait, copy-out on the host clock; the forward's and
   the weight dequantization's device time with the host's issue hidden
   behind a spin on the stream).
5. A JSON line listing every kernel (``launches`` is the count on the
   path that runs it: ``main`` for conv, maxpool and resize,
   ``fusion_off`` for pointwise; ``launches_by_path`` has both), then
   the result line.

Needs one CUDA card; exits non-zero without one, and in a directory that
does not hold the repository's ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12             # H100 SXM HBM3
IMG, BATCH, N_REQ = 640, 8, 32
MAIN_TOL = 1e-3
# Random weights are the He-scaled init times this gain: at the plain
# scale the activations decay to ~1e-10 by the detect heads (no BN, W8
# storage), which would make a 1e-3 output comparison vacuous; at 1.75
# the heads stay at 0.1–1.
WEIGHT_GAIN = 1.75
KERNEL_TOL = {"conv2d": 1e-4, "pointwise": 1e-4,
              "maxpool2d": 0.0, "resize_nearest": 0.0}   # 0: bit-equal
# FLOPs per element of each activation (for the pointwise bound).
ACT_FLOPS = {"identity": 0, "none": 0, "relu": 1, "leaky_relu": 2,
             "hardswish": 5, "silu": 5, "gelu": 10}
SOURCES = {
    "conv2d": ("src/repro_torch/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:132"),
    "maxpool2d": ("src/repro_torch/csrc/maxpool.cu",
                  "src/repro/kernels/maxpool.py:39"),
    "resize_nearest": ("src/repro_torch/csrc/resize.cu",
                       "src/repro/kernels/resize.py:29"),
    "pointwise": ("src/repro_torch/csrc/pointwise.cu",
                  "src/repro/kernels/pointwise.py:26"),
}
# The path whose launch count a kernel reports in the kernels line.
KERNEL_PATH = {"conv2d": "main", "maxpool2d": "main",
               "resize_nearest": "main", "pointwise": "fusion_off"}
# (input H, C, K, F, stride, act, res) of the conv cases: all conv
# launches of yolov8n at 640 after the default passes.
CONV_CASES = {
    "stem_3x3s2_640": (640, 3, 3, 16, 2, "hardswish", False),
    "3x3s2_160": (160, 32, 3, 64, 2, "hardswish", False),
    "3x3s1_res_160": (160, 16, 3, 16, 1, "hardswish", True),
    "3x3s1_res_80": (80, 32, 3, 32, 1, "hardswish", True),
    "3x3s1_head_80": (80, 64, 3, 64, 1, "hardswish", False),
    "1x1_c2f_80": (80, 192, 1, 64, 1, "hardswish", False),
    "1x1_cls_80": (80, 64, 1, 80, 1, "identity", False),
}


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(torch, fn, budget_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(min(200, max(5, budget_ms / one)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, reps: int = 3) -> tuple[float, float]:
    """(device ms, host issue ms) of one call of ``fn``, median of
    ``reps``. A spin queued first keeps the card busy while the host
    issues ``fn``, so the events around it time the device work alone;
    the spin is long enough when the issue is shorter than it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev, host = [], []
    fn()
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(500_000_000)          # ~0.25 s at 1.98 GHz
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return sorted(dev)[reps // 2], sorted(host)[reps // 2]


def bound(flops: float, nbytes: float) -> tuple[float, float]:
    """(ms bound by operations, ms bound by bytes)."""
    return flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def conv_launch_shapes(codegen, graph) -> set:
    """(output H, C, K, F, stride, act, res) of every conv launch."""
    out = set()
    for name in codegen.launch_nodes(graph):
        n = graph.nodes[name]
        if n.op == "conv":
            out.add((n.geom("H"), n.geom("C"), n.geom("K"), n.geom("F"),
                     n.geom("stride"), n.attrs.get("act", "identity"),
                     bool(n.attrs.get("fuse_add"))))
    return out


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version, at yolov8n@640 shapes
# --------------------------------------------------------------------------

def kernel_cases(torch, F, K, dev, conv_shapes: set):
    """(kernel, case, kernel_fn, plain_fn, library_fn, flops, bytes)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = []
    nb = 4   # bytes per float32
    for name, (H, C, Kk, Fo, s, act, use_res) in CONV_CASES.items():
        Ho = -(-H // s)
        if (Ho, C, Kk, Fo, s, act, use_res) not in conv_shapes:
            raise AssertionError(f"conv case {name} is not a conv launch "
                                 f"of the compiled yolov8n")
        x = rnd(BATCH, H, H, C)
        w = rnd(Kk, Kk, C, Fo, scale=(Kk * Kk * C) ** -0.5)
        b = rnd(Fo, scale=0.1)
        res = rnd(BATCH, Ho, Ho, Fo) if use_res else None
        xn = x.permute(0, 3, 1, 2)              # channels-last NCHW view
        wn = w.permute(3, 2, 0, 1).contiguous()
        flops = 2 * BATCH * Ho * Ho * Kk * Kk * C * Fo
        nbytes = nb * (x.numel() + w.numel() + b.numel()
                       + BATCH * Ho * Ho * Fo * (2 if use_res else 1))
        cases.append((
            "conv2d", name,
            lambda x=x, w=w, b=b, s=s, a=act, r=res: K.conv2d.conv2d(
                x, w, b, stride=s, act=a, res=r),
            lambda x=x, w=w, b=b, s=s, a=act, r=res: K.ref.conv2d(
                x, w, b, stride=s, act=a, res=r),
            lambda xn=xn, wn=wn, b=b, s=s, k=Kk: F.conv2d(
                xn, wn, b, stride=s, padding=k // 2),
            flops, nbytes))
    for name, (H, C, k, s, act) in {
            "5x5s1_sppf_20": (20, 128, 5, 1, "identity"),
            "2x2s2_leaky_80": (80, 64, 2, 2, "leaky_relu"),
            "2x2s1_leaky_13": (13, 128, 2, 1, "leaky_relu")}.items():
        x = rnd(BATCH, H, H, C)
        Ho = -(-H // s)
        xn = x.permute(0, 3, 1, 2)
        cases.append((
            "maxpool2d", name,
            lambda x=x, k=k, s=s, a=act: K.maxpool.maxpool2d(
                x, k=k, stride=s, act=a),
            lambda x=x, k=k, s=s, a=act: K.ref.maxpool2d(
                x, k=k, stride=s, act=a),
            lambda xn=xn, k=k, s=s: F.max_pool2d(xn, k, s, (k - 1) // 2),
            BATCH * Ho * Ho * C * (k * k + ACT_FLOPS[act]),
            nb * (x.numel() + BATCH * Ho * Ho * C)))
    xr = rnd(BATCH, 20, 20, 256)
    xrn = xr.permute(0, 3, 1, 2)
    cases.append((
        "resize_nearest", "20x20x256_to_40",
        lambda: K.resize.resize_nearest(xr, scale=2),
        lambda: K.ref.resize_nearest(xr, scale=2),
        lambda: F.interpolate(xrn, scale_factor=2, mode="nearest"),
        0, nb * xr.numel() * 5))
    xp = rnd(BATCH, 80, 80, 64, scale=3.0)
    library = {"hardswish": F.hardswish, "relu": F.relu, "silu": F.silu,
               "leaky_relu": lambda t: F.leaky_relu(t, 0.1),
               "gelu": lambda t: F.gelu(t, approximate="tanh"),
               "identity": torch.clone, "none": torch.clone}
    for act in sorted(ACT_FLOPS):
        cases.append((
            "pointwise", act,
            lambda a=act: K.pointwise.pointwise(xp, a),
            lambda a=act: K.ref.pointwise(xp, a),
            lambda a=act: library[a](xp),
            xp.numel() * ACT_FLOPS[act], nb * xp.numel() * 2))
    return cases


def check_kernels(torch, F, K, dev, conv_shapes: set) -> dict:
    per_kernel: dict = {}
    for kname, case, kfn, pfn, lfn, flops, nbytes in kernel_cases(
            torch, F, K, dev, conv_shapes):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        tol = KERNEL_TOL[kname]
        err = float((got - want).abs().max())
        ok = bool(torch.equal(got, want)) if tol == 0 else bool(
            torch.allclose(got, want, atol=tol, rtol=tol))
        t_k, t_p, t_l = (cuda_ms(torch, kfn), cuda_ms(torch, pfn),
                         cuda_ms(torch, lfn))
        b_ops, b_bytes = bound(flops, nbytes)
        print(f"  {kname:15s} {case:18s} max_abs_err={err:.3e} "
              f"(tol {'bit-equal' if tol == 0 else tol}) "
              f"kernel={t_k:.4f}ms plain={t_p:.4f}ms library={t_l:.4f}ms "
              f"bound={max(b_ops, b_bytes):.4f}ms "
              f"({'operations' if b_ops >= b_bytes else 'bytes'})",
              flush=True)
        if not ok:
            raise AssertionError(f"{kname}[{case}] disagrees with its "
                                 f"plain version: max_abs_err={err}")
        agg = per_kernel.setdefault(kname, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0, "cases": []})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bound_ms", max(b_ops, b_bytes)),
                       ("ops_ms", b_ops), ("bytes_ms", b_bytes)):
            agg[key] += v
        agg["cases"].append({"case": case, "ms": t_k, "plain_ms": t_p,
                             "library_ms": t_l, "max_abs_err": err,
                             "bound_ms": max(b_ops, b_bytes),
                             "bound_by": "operations" if b_ops >= b_bytes
                             else "bytes"})
    return per_kernel


# --------------------------------------------------------------------------
# phase 3: the main path through the user's entry points
# --------------------------------------------------------------------------

def serve(Deployment, DetectRequest, ImageStream, acc, n_req, img, seed):
    images = list(ImageStream(img, BATCH, seed=seed).frames(n_req))
    t0 = time.perf_counter()
    with Deployment(acc) as dep:
        for i, im in enumerate(images):
            if not dep.submit(DetectRequest(uid=i, image=im)):
                raise AssertionError(f"request {i} rejected")
        done = dep.run()
        stats = dep.stats()             # counters + latency/busy snapshot
    wall = time.perf_counter() - t0
    return images, done, stats, wall


def random_params(torch, codegen, graph, seed: int) -> dict:
    params = codegen.init_params(graph, torch.Generator().manual_seed(seed))
    for p in params.values():
        p["w"] *= WEIGHT_GAIN
    return params


def check_outputs(torch, np, acc, images, done, shapes) -> tuple:
    """Every request done, outputs finite with the expected shapes, and
    within MAIN_TOL of the same graph on the plain versions (card)."""
    if len(done) != len(images) or not all(r.done for r in done):
        raise AssertionError(f"{sum(r.done for r in done)}/{len(images)} "
                             f"requests done")
    worst = scale = 0.0
    for i in range(0, len(images), BATCH):
        xb = torch.from_numpy(np.stack(images[i:i + BATCH])).to(
            acc.torch_device)
        want = [o.cpu() for o in acc.forward(xb, backend="ref")]
        for j, req in enumerate(done[i:i + BATCH]):
            if req.uid != i + j:
                raise AssertionError(f"request {req.uid} out of order")
            got_shapes = [tuple(o.shape) for o in req.outputs]
            if got_shapes != shapes:
                raise AssertionError(f"output shapes {got_shapes} != "
                                     f"{shapes}")
            for o, w in zip(req.outputs, want):
                g = torch.from_numpy(o)
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError("non-finite output")
                worst = max(worst, float((g - w[j]).abs().max()))
                scale = max(scale, float(w[j].abs().max()))
                if not torch.allclose(g, w[j], atol=MAIN_TOL, rtol=MAIN_TOL):
                    raise AssertionError(
                        f"request {req.uid}: max_abs_err "
                        f"{float((g - w[j]).abs().max())} vs ref")
    return worst, scale


def replica_spans(torch, AcceleratorReplica, DetectRequest, QTensor,
                  dequantize, acc, images, steps: int = 8) -> dict:
    """Median spans (ms) of one replica step run alone on the caller's
    thread: ``assemble`` (stack, pin, start the upload), ``issue`` (the
    host launching the forward), ``wait`` (the card finishing after the
    issue returned), ``copy_out`` (outputs to numpy); then the device
    time and host issue time of the forward and of dequantizing every
    weight, each measured with the issue hidden (``device_ms``)."""
    rep = AcceleratorReplica(acc)
    spans: dict = {k: [] for k in ("assemble", "issue", "wait",
                                   "copy_out", "step")}
    for i in range(steps + 1):                  # step 0 warms up
        batch = [DetectRequest(uid=j, image=im)
                 for j, im in enumerate(images[:BATCH])]
        t0 = time.perf_counter()
        prepared = rep.assemble(batch)
        t1 = time.perf_counter()
        handle = rep.execute(prepared)
        t2 = time.perf_counter()
        handle[-1].synchronize()                # the step's CUDA event
        t3 = time.perf_counter()
        rep.complete(handle)
        t4 = time.perf_counter()
        if i:
            for k, a, b in (("assemble", t0, t1), ("issue", t1, t2),
                            ("wait", t2, t3), ("copy_out", t3, t4),
                            ("step", t0, t4)):
                spans[k].append((b - a) * 1e3)
    out = {k: sorted(v)[len(v) // 2] for k, v in spans.items()}
    xb = prepared[-1]
    weights = [p["w"] for p in acc.params.values()
               if isinstance(p["w"], QTensor)]
    out["forward_device"], out["forward_issue"] = device_ms(
        torch, lambda: acc.forward(xb))
    out["dequant_device"], out["dequant_issue"] = device_ms(
        torch, lambda: [dequantize(w) for w in weights])
    out["dequant_tensors"] = len(weights)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch.nn.functional as F
        import repro_torch.core as core
        from repro_torch.core import codegen
        from repro_torch.data.synthetic import ImageStream
        from repro_torch.kernels import _build
        from repro_torch.kernels import (conv2d, maxpool, pointwise, ref,
                                         resize)
        from repro_torch.models import yolo
        from repro_torch.core.quant import QTensor, dequantize
        from repro_torch.serve import (AcceleratorReplica, Deployment,
                                       DetectRequest)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from "
              f"{ROOT / 'src'}: {e}", file=sys.stderr)
        return 3

    K = types.SimpleNamespace(conv2d=conv2d, maxpool=maxpool, resize=resize,
                              pointwise=pointwise, ref=ref)
    counters = {"conv2d": conv2d.launches, "maxpool2d": maxpool.launches,
                "resize_nearest": resize.launches,
                "pointwise": pointwise.launches}

    # ---------------------------------------------------------------- 1
    card = smi()
    print(f"[env] nvidia-smi: {card}", flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"[build] {'built' if info['built'] else 'loaded'} {info['path']} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS[:2])}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- 2
    model = yolo.build("yolov8n")
    t0 = time.perf_counter()
    acc = core.compile(model, core.CompileConfig(batch_size=BATCH,
                                                 replicas=2),
                       params=random_params(torch, codegen, model.graph, 0))
    print(f"[main] compiled {acc.name} on {acc.torch_device} in "
          f"{time.perf_counter() - t0:.1f}s; launch nodes per forward: "
          f"{len(codegen.launch_nodes(acc.graph))}", flush=True)
    print("[kernels] each kernel vs its plain version on the card", flush=True)
    per_kernel = check_kernels(torch, F, K, torch.device("cuda", 0),
                               conv_launch_shapes(codegen, acc.graph))

    # ---------------------------------------------------------------- 3
    model_off = yolo.build("yolov8n", 160)
    acc_off = core.compile(model_off,
                           core.CompileConfig(batch_size=BATCH, passes=()),
                           params=random_params(torch, codegen,
                                                model_off.graph, 1))

    def drive(acc_, n_req, img, seed):
        for c in counters.values():
            c.reset()
        run = serve(Deployment, DetectRequest, ImageStream, acc_, n_req,
                    img, seed)
        return run, {k: c.value for k, c in counters.items()}

    (images, done, stats, wall), main_counts = drive(acc, N_REQ, IMG, 0)
    batches = stats["batches"]
    print(f"[main] served {stats['frames']} requests in {batches} batches "
          f"on {stats['replicas']} replicas; launches {main_counts}")
    want = {"conv2d": 63 * batches, "maxpool2d": 3 * batches,
            "resize_nearest": 2 * batches, "pointwise": 0}
    if batches != N_REQ // BATCH or main_counts != want:
        raise AssertionError(f"main path launches {main_counts} over "
                             f"{batches} batches, expected {want}")
    err_main, scale_main = check_outputs(
        torch, np, acc, images, done,
        [(80, 80, 144), (40, 40, 144), (20, 20, 144)])
    print(f"[main] outputs within {MAIN_TOL} of backend='ref' on the card "
          f"(max_abs_err {err_main:.3e}, max |output| {scale_main:.3e})",
          flush=True)

    (images_off, done_off, stats_off, _), off_counts = drive(
        acc_off, BATCH, 160, 1)
    want_off = {"conv2d": 63, "maxpool2d": 3, "resize_nearest": 2,
                "pointwise": 57}
    if stats_off["batches"] != 1 or off_counts != want_off:
        raise AssertionError(f"fusion-off launches {off_counts} over "
                             f"{stats_off['batches']} batches, expected "
                             f"{want_off} for one")
    err_off, scale_off = check_outputs(
        torch, np, acc_off, images_off, done_off,
        [(20, 20, 144), (10, 10, 144), (5, 5, 144)])
    print(f"[fusion_off] yolov8n@160 passes=(): launches per forward "
          f"{off_counts}; outputs within {MAIN_TOL} of backend='ref' "
          f"(max_abs_err {err_off:.3e}, max |output| {scale_off:.3e})",
          flush=True)
    paths = {"main": main_counts, "fusion_off": off_counts}
    for kname, path in KERNEL_PATH.items():
        if paths[path][kname] <= 0:
            raise AssertionError(f"{kname} never launched on {path}")

    # ---------------------------------------------------------------- 4
    # A short serving window after warm-up: a smoke reading of the
    # serving loop, not a benchmark (64 requests, well under a second).
    _, _, stats2, wall2 = serve(Deployment, DetectRequest,
                                ImageStream, acc, 2 * N_REQ, IMG, seed=2)
    ms_batch = wall2 / stats2["batches"] * 1e3
    fps = stats2["frames"] / wall2
    xb = torch.from_numpy(ImageStream(IMG, BATCH, seed=3).batch_at(0)).cuda()
    fwd_ms = cuda_ms(torch, lambda: acc.forward(xb), budget_ms=500)
    ref_ms = cuda_ms(torch, lambda: acc.forward(xb, backend="ref"),
                     budget_ms=500)
    lat = stats2["latency"]
    busy = [r["busy_frac"] for r in stats2["per_replica"]]
    print(f"[timing] {card}: Deployment smoke window {ms_batch:.2f} ms/batch "
          f"of {BATCH}, {fps:.1f} frames/s over {stats2['frames']} "
          f"requests (first run incl. warm-up: {wall:.2f}s); per-batch "
          f"service time on the replica workers (execute + copy-out) p50 "
          f"{lat['p50_ms']} ms, busy fractions {busy}; executor forward "
          f"back to back {fwd_ms:.3f} ms/batch on the kernels, "
          f"{ref_ms:.3f} ms/batch on the plain versions", flush=True)
    spans = replica_spans(torch, AcceleratorReplica, DetectRequest, QTensor,
                          dequantize, acc, images)
    print(f"[timing] one replica step alone, median ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()), flush=True)

    # ---------------------------------------------------------------- 5
    kernels = []
    for kname, agg in per_kernel.items():
        src, replaces = SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": paths[KERNEL_PATH[kname]][kname],
            "path": KERNEL_PATH[kname],
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": "operations" if agg["ops_ms"] >= agg["bytes_ms"]
            else "bytes",
            "library_ms": agg["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "torch": torch.__version__,
            "kernels": kernels,
            "cases": {k: v["cases"] for k, v in per_kernel.items()},
            "main": {"launches": paths, "max_abs_err": err_main,
                     "max_abs_out": scale_main,
                     "fusion_off_max_abs_err": err_off,
                     "ms_per_batch": ms_batch,
                     "frames_per_s": fps, "forward_ms": fwd_ms,
                     "service_p50_ms": lat["p50_ms"], "busy_frac": busy,
                     "forward_ref_ms": ref_ms, "batch": BATCH,
                     "replica_step_spans_ms": spans},
            "build_s": info["seconds"]}, indent=1))
    print(f"[card] {smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
