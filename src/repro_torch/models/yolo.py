"""YOLO model family (v3-tiny / v5 / v8) — the paper's own workloads.

Each builder emits a single ``core.ir.Graph`` — SATAY's internal
representation. It is the ONE source of truth: the DSE (Algorithm 1),
the buffer allocator (Algorithm 2), the analytic performance models AND
the generated executor (core/codegen.py) all read it; there is no
parallel executor plan. Activation functions are separate IR nodes
because the paper's resource model costs them separately (conv K²·p,
HardSwish 2·p, LeakyReLU p); epilogue fusion for execution is a
compiler pass (core/passes.py:FuseConvAct), not a builder concern.

Builders emit the network-NATIVE activations (SiLU for v5/v8,
LeakyReLU for v3-tiny). The paper's SiLU→HardSwish substitution
(Fig. 7 / §VI) is applied by the ``SubstituteActivation`` pass in the
default compile pipeline — parse what the network is, rewrite what the
hardware wants. BatchNorm is assumed folded into conv weights (standard
for inference toolflows; the paper quantizes folded ONNX weights).

A copy of the JAX package's builders; only ``YoloModel.init``/``forward``
bind this package's torch codegen.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..core import codegen, ir


@dataclasses.dataclass(frozen=True)
class YoloCfg:
    name: str
    version: str                  # v3t | v5 | v8
    img_size: int = 640
    in_ch: int = 3
    num_classes: int = 80
    width_mult: float = 1.0
    depth_mult: float = 1.0
    act: str = "silu"             # network-native; substitution is a pass
    reg_max: int = 16             # v8 DFL bins


def make_divisible(x: float, div: int = 8) -> int:
    return max(div, int(math.ceil(x / div) * div))


# ---------------------------------------------------------------------------
# Graph builder: emits IR only — codegen generates the executor from it
# ---------------------------------------------------------------------------

class Builder:
    def __init__(self, cfg: YoloCfg):
        self.cfg = cfg
        self.g = ir.Graph(name=cfg.name)
        self._n = 0
        s = cfg.img_size
        self.g.add_stream("in", (s, s, cfg.in_ch))
        self.g.inputs.append("in")

    def _uid(self, kind: str) -> str:
        self._n += 1
        return f"{kind}{self._n}"

    def shape(self, stream: str) -> tuple[int, int, int]:
        return self.g.streams[stream].shape  # (H, W, C)

    # -- primitives --------------------------------------------------------
    def conv(self, src: str, f: int, k: int = 1, s: int = 1,
             act: str | None = None) -> str:
        act = self.cfg.act if act is None else act
        H, W, C = self.shape(src)
        Ho, Wo = -(-H // s), -(-W // s)
        name = self._uid("conv")
        mid = f"{name}_raw"
        self.g.add_stream(mid, (Ho, Wo, f))
        self.g.add_node(name, "conv", [src], [mid], H=Ho, W=Wo, C=C, F=f,
                        K=k, stride=s, groups=1, W_in=W, act="identity")
        if act in ("identity", "none"):
            return mid
        aname = self._uid(act)
        out = f"{aname}_out"
        self.g.add_stream(out, (Ho, Wo, f))
        self.g.add_node(aname, act, [mid], [out], H=Ho, W=Wo, C=f)
        return out

    def maxpool(self, src: str, k: int = 2, s: int | None = None) -> str:
        s = s or k
        H, W, C = self.shape(src)
        Ho, Wo = -(-H // s), -(-W // s)
        name = self._uid("pool")
        out = f"{name}_out"
        self.g.add_stream(out, (Ho, Wo, C))
        self.g.add_node(name, "maxpool", [src], [out], H=Ho, W=Wo, C=C,
                        K=k, stride=s, W_in=W)
        return out

    def upsample(self, src: str, scale: int = 2) -> str:
        H, W, C = self.shape(src)
        name = self._uid("resize")
        out = f"{name}_out"
        self.g.add_stream(out, (H * scale, W * scale, C))
        self.g.add_node(name, "resize", [src], [out], H=H * scale,
                        W=W * scale, C=C, scale=scale)
        return out

    def concat(self, srcs: list[str]) -> str:
        shapes = [self.shape(s) for s in srcs]
        H, W = shapes[0][0], shapes[0][1]
        C = sum(s[2] for s in shapes)
        name = self._uid("concat")
        out = f"{name}_out"
        self.g.add_stream(out, (H, W, C))
        self.g.add_node(name, "concat", list(srcs), [out], H=H, W=W, C=C)
        return out

    def add(self, a: str, b: str) -> str:
        H, W, C = self.shape(a)
        name = self._uid("add")
        out = f"{name}_out"
        self.g.add_stream(out, (H, W, C))
        self.g.add_node(name, "add", [a, b], [out], H=H, W=W, C=C)
        return out

    # -- composite blocks ---------------------------------------------------
    def bottleneck(self, src: str, c: int, shortcut: bool = True) -> str:
        y = self.conv(src, c, 1)
        y = self.conv(y, c, 3)
        return self.add(src, y) if shortcut else y

    def c3(self, src: str, c_out: int, n: int, shortcut: bool = True) -> str:
        c_ = c_out // 2
        a = self.conv(src, c_, 1)
        b = self.conv(src, c_, 1)
        for _ in range(n):
            a = self.bottleneck(a, c_, shortcut)
        return self.conv(self.concat([a, b]), c_out, 1)

    def c2f(self, src: str, c_out: int, n: int, shortcut: bool = False) -> str:
        c_ = c_out // 2
        y = self.conv(src, c_out, 1)
        # split into two halves (stream split node)
        H, W, C = self.shape(y)
        sname = self._uid("split")
        outs = [f"{sname}_a", f"{sname}_b"]
        for o in outs:
            self.g.add_stream(o, (H, W, c_))
        self.g.add_node(sname, "split", [y], outs, H=H, W=W, C=C,
                        sizes=(c_, c_))
        chunks = [outs[0], outs[1]]
        cur = outs[1]
        for _ in range(n):
            cur = self.bottleneck(cur, c_, shortcut)
            chunks.append(cur)
        return self.conv(self.concat(chunks), c_out, 1)

    def sppf(self, src: str, c_out: int, k: int = 5) -> str:
        c_ = c_out // 2
        x = self.conv(src, c_, 1)
        p1 = self.maxpool(x, k, 1)
        p2 = self.maxpool(p1, k, 1)
        p3 = self.maxpool(p2, k, 1)
        return self.conv(self.concat([x, p1, p2, p3]), c_out, 1)

    def detect_v5(self, srcs: list[str]) -> list[str]:
        no = 3 * (5 + self.cfg.num_classes)
        return [self.conv(s, no, 1, act="identity") for s in srcs]

    def detect_v8(self, srcs: list[str]) -> list[str]:
        outs = []
        for s in srcs:
            c = self.shape(s)[2]
            reg = self.conv(self.conv(s, max(c // 4, 64), 3),
                            max(c // 4, 64), 3)
            reg = self.conv(reg, 4 * self.cfg.reg_max, 1, act="identity")
            cls = self.conv(self.conv(s, max(c // 4, 64), 3),
                            max(c // 4, 64), 3)
            cls = self.conv(cls, self.cfg.num_classes, 1, act="identity")
            outs.append(self.concat([reg, cls]))
        return outs

    def finish(self, outputs: list[str]) -> "YoloModel":
        self.g.outputs.extend(outputs)
        self.g.validate()
        return YoloModel(cfg=self.cfg, graph=self.g, outputs=outputs)


# ---------------------------------------------------------------------------
# architectures
# ---------------------------------------------------------------------------

def build_v5(cfg: YoloCfg) -> "YoloModel":
    w, d = cfg.width_mult, cfg.depth_mult
    ch = lambda c: make_divisible(c * w)
    rep = lambda n: max(1, round(n * d))
    b = Builder(cfg)
    x = b.conv("in", ch(64), 6, 2)
    x = b.conv(x, ch(128), 3, 2)
    x = b.c3(x, ch(128), rep(3))
    x = b.conv(x, ch(256), 3, 2)
    p3 = b.c3(x, ch(256), rep(6))
    x = b.conv(p3, ch(512), 3, 2)
    p4 = b.c3(x, ch(512), rep(9))
    x = b.conv(p4, ch(1024), 3, 2)
    x = b.c3(x, ch(1024), rep(3))
    x = b.sppf(x, ch(1024))
    # head (FPN + PAN)
    h10 = b.conv(x, ch(512), 1)
    x = b.concat([b.upsample(h10), p4])
    x = b.c3(x, ch(512), rep(3), shortcut=False)
    h14 = b.conv(x, ch(256), 1)
    x = b.concat([b.upsample(h14), p3])
    o3 = b.c3(x, ch(256), rep(3), shortcut=False)
    x = b.conv(o3, ch(256), 3, 2)
    x = b.concat([x, h14])
    o4 = b.c3(x, ch(512), rep(3), shortcut=False)
    x = b.conv(o4, ch(512), 3, 2)
    x = b.concat([x, h10])
    o5 = b.c3(x, ch(1024), rep(3), shortcut=False)
    return b.finish(b.detect_v5([o3, o4, o5]))


def build_v8(cfg: YoloCfg) -> "YoloModel":
    w, d = cfg.width_mult, cfg.depth_mult
    ch = lambda c: make_divisible(min(c, 1024) * w)
    rep = lambda n: max(1, round(n * d))
    b = Builder(cfg)
    x = b.conv("in", ch(64), 3, 2)
    x = b.conv(x, ch(128), 3, 2)
    x = b.c2f(x, ch(128), rep(3), True)
    x = b.conv(x, ch(256), 3, 2)
    p3 = b.c2f(x, ch(256), rep(6), True)
    x = b.conv(p3, ch(512), 3, 2)
    p4 = b.c2f(x, ch(512), rep(6), True)
    x = b.conv(p4, ch(1024), 3, 2)
    x = b.c2f(x, ch(1024), rep(3), True)
    p5 = b.sppf(x, ch(1024))
    x = b.concat([b.upsample(p5), p4])
    h12 = b.c2f(x, ch(512), rep(3))
    x = b.concat([b.upsample(h12), p3])
    o3 = b.c2f(x, ch(256), rep(3))
    x = b.concat([b.conv(o3, ch(256), 3, 2), h12])
    o4 = b.c2f(x, ch(512), rep(3))
    x = b.concat([b.conv(o4, ch(512), 3, 2), p5])
    o5 = b.c2f(x, ch(1024), rep(3))
    return b.finish(b.detect_v8([o3, o4, o5]))


def build_v3_tiny(cfg: YoloCfg) -> "YoloModel":
    b = Builder(cfg)
    act = "leaky_relu"
    x = b.conv("in", 16, 3, 1, act)
    x = b.maxpool(x, 2)
    x = b.conv(x, 32, 3, 1, act)
    x = b.maxpool(x, 2)
    x = b.conv(x, 64, 3, 1, act)
    x = b.maxpool(x, 2)
    x = b.conv(x, 128, 3, 1, act)
    x = b.maxpool(x, 2)
    r8 = b.conv(x, 256, 3, 1, act)
    x = b.maxpool(r8, 2)
    x = b.conv(x, 512, 3, 1, act)
    x = b.maxpool(x, 2, 1)
    x = b.conv(x, 1024, 3, 1, act)
    r13 = b.conv(x, 256, 1, 1, act)
    yl = b.conv(r13, 512, 3, 1, act)
    yl = b.conv(yl, 3 * (5 + cfg.num_classes), 1, act="identity")
    x = b.conv(r13, 128, 1, 1, act)
    x = b.concat([b.upsample(x), r8])
    ym = b.conv(x, 256, 3, 1, act)
    ym = b.conv(ym, 3 * (5 + cfg.num_classes), 1, act="identity")
    return b.finish([yl, ym])


YOLO_CONFIGS = {
    "yolov3-tiny": YoloCfg("yolov3-tiny", "v3t", img_size=416,
                           act="leaky_relu"),
    "yolov5n": YoloCfg("yolov5n", "v5", width_mult=0.25, depth_mult=0.33),
    "yolov5s": YoloCfg("yolov5s", "v5", width_mult=0.5, depth_mult=0.33),
    "yolov8n": YoloCfg("yolov8n", "v8", width_mult=0.25, depth_mult=0.33),
    "yolov8s": YoloCfg("yolov8s", "v8", width_mult=0.5, depth_mult=0.33),
}

_BUILDERS = {"v3t": build_v3_tiny, "v5": build_v5, "v8": build_v8}


def build(name: str, img_size: int | None = None) -> "YoloModel":
    cfg = YOLO_CONFIGS[name]
    if img_size:
        cfg = dataclasses.replace(cfg, img_size=img_size)
    return _BUILDERS[cfg.version](cfg)


# ---------------------------------------------------------------------------
# parameters + executor (both derived from the graph alone)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class YoloModel:
    cfg: YoloCfg
    graph: ir.Graph
    outputs: list[str]
    _forward: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None) -> dict:
        return codegen.init_params(self.graph, generator, dtype, device)

    def forward(self, params: dict, x: torch.Tensor,
                backend: str | None = None) -> list[torch.Tensor]:
        """x: (N, H, W, C) → list of detect-head feature maps (NHWC).

        The executor is generated once from ``graph.topo_order()`` by
        core/codegen.py and cached; there is no separate plan.
        """
        if self._forward is None:
            self._forward = codegen.generate(self.graph, self.outputs)
        return self._forward(params, x, backend=backend)

    def gflops(self) -> float:
        return 2 * self.graph.total_macs() / 1e9

    def gmacs(self) -> float:
        return self.graph.total_macs() / 1e9

    def n_params(self) -> int:
        return self.graph.total_weights()
