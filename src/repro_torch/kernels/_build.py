"""Build, load and guard the port's CUDA kernels.

All sources under ``repro_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` (Hopper) into ONE shared library with a plain C interface,
loaded with ``ctypes``. The build happens at first use, never at import:
every ``.cu`` compiles in its own ``nvcc`` process, all started together,
and one link step makes the library. It lands in ``build/kernels/<hash>/``
at the repository root (listed in ``.gitignore``), keyed by a hash of the
sources and flags, so an unchanged checkout loads the existing library.

Each wrapper counts its launches on a :class:`LaunchCounter`, checks its
operands with :func:`check_operand`, and raises when the C function
returns a CUDA error: a refused launch never runs, and a later
synchronise would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

# Activation codes shared with csrc/common.cuh (enum Act); the keys are
# exactly ref.ACTIVATIONS'.
ACT_CODES = {"identity": 0, "none": 0, "hardswish": 1, "leaky_relu": 2,
             "silu": 3, "relu": 4, "gelu": 5}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_conv2d_nhwc_f32": [_P, _P, _P, _P, _P] + [_I] * 12 + [_P],
    "repro_maxpool2d_nhwc_f32": [_P, _P] + [_I] * 11 + [_P],
    "repro_resize_nearest_nhwc_f32": [_P, _P] + [_I] * 5 + [_P],
    "repro_pointwise_f32": [_P, _P, _LL, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}           # filled by the first library() call


class LaunchCounter:
    """A count of kernel launches, safe across the serving threads."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def act_code(act: str) -> int:
    try:
        return ACT_CODES[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; expected one of "
                         f"{sorted(ACT_CODES)}") from None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's CUDA kernels "
                       "are built from source at first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> dict:
    """Compile every source in parallel, then link; returns build info."""
    nvcc = _nvcc()
    # objects go to a per-process directory and the library appears by
    # an atomic rename, so two processes building at once cannot mix
    # each other's half-written files
    work = out_dir / f"objs.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out_dir / LIB_NAME)
    shutil.rmtree(work, ignore_errors=True)
    log = "\n".join(logs)
    return {"built": True, "seconds": time.perf_counter() - t0,
            "sources": [n for n, _, _ in procs], "log": log}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _source_hash()
        path = out_dir / LIB_NAME
        info = {"built": False, "seconds": 0.0}
        if not path.exists():
            info = _build(out_dir)
        lib = ctypes.CDLL(str(path))
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        build_info.update(info, path=str(path))
        _lib = lib
        return lib


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  shape: tuple | None = None) -> None:
    """Raise unless ``t`` is what the kernels take: a contiguous float32
    tensor on ``device`` (with ``shape`` when given) whose elements an
    int32 index reaches."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}; the kernels take float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous (a channel-split view?); "
                         f"make it contiguous before the launch")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         f"index with int32")


def launch(fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` on ``device``'s current stream and raise
    on a CUDA error code."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")
