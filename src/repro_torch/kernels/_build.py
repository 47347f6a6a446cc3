"""Build, load and guard the port's CUDA kernels.

All sources under ``repro_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` (Hopper) into ONE shared library with a plain C interface,
loaded with ``ctypes``. The build happens at first use, never at import:
every ``.cu`` compiles in its own ``nvcc`` process, all started together,
and one link step makes the library. It lands in ``build/kernels/<hash>/``
at the repository root (listed in ``.gitignore``), keyed by a hash of the
sources, the headers written from Python (:func:`generated_headers`) and
the flags, so an unchanged checkout loads the existing library.

Each wrapper counts its launches on a :class:`LaunchCounter`, checks its
operands with :func:`check_operand`, and raises when the C function
returns a CUDA error: a refused launch never runs, and a later
synchronise would not report it.
"""
from __future__ import annotations

import ctypes
import functools
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

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {
    "repro_conv2d_nhwc_f32": [_P, _P, _P, _P, _P] + [_I] * 15 + [_P, _P],
    "repro_conv2d_nhwc_f32_double": [_P, _P, _P, _P, _P] + [_I] * 15
    + [_P, _P],
    "repro_maxpool2d_nhwc_f32": [_P, _P, _P, _P],
    "repro_resize_nearest_nhwc_f32": [_P, _P] + [_I] * 9 + [_P],
    "repro_pointwise_f32": [_P, _P, _LL, _LL, _LL, _I, _I, _P],
    "repro_qmatmul_f32": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P]
    + [_I] * 7 + [_P, _P],
    "repro_qmatmul_a8": [_P, _P, _I, _P, _I, _P, _I, _F, _P, _P, _P]
    + [_I] * 7 + [_P, _P],
    "repro_qmatmul_a8_double": [_P, _P, _I, _P, _I, _P, _I, _F, _P, _P,
                                _P] + [_I] * 7 + [_P, _P],
    "repro_qmatmul_a8_grouped": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _P,
                                 _P, _P] + [_I] * 8 + [_P, _P],
    "repro_rmsnorm_f32": [_P, _P, _P, _LL, _I, _F, _I, _P],
    "repro_mha_f32": [_P] * 4 + [_I] * 8 + [_F, _F] + [_I] * 4 + [_P, _P],
    "repro_decode_attention_f32": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _P],
    "repro_decode_smem_bytes": [_I, _I],
    "repro_ssd_scan_f32": [_P] * 9 + [_I] * 7 + [_P],
    "repro_ssd_smem_bytes": [_I, _I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}                 # entry point name -> bound ctypes function
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


PIPELINES = ("grid", "double")


def check_pipeline(pipeline: str) -> None:
    """Raise on a ``pipeline`` other than ``"grid"`` or ``"double"``.
    (The JAX package runs its grid kernel for any other string; the port
    refuses it.)"""
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline={pipeline!r}: expected one of "
                         f"{PIPELINES}")


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


def generated_headers() -> dict[str, str]:
    """Headers the sources include that are written from Python at
    build time: ``qmm_tiles.h``, the K stage and compiled (BM, BN) tiles
    of kernel #7, of kernels #8/#10 and of kernel #9, from
    ``kernels/qmatmul.py`` (``_BK``, ``TILES``; ``_A8_BK``, ``A8_TILES``;
    ``A8G_TILES``), and ``conv_tiles.h``,
    the slice depth and tiles of kernels #1/#2, from ``kernels/conv2d.py``
    (``_CONV_BK``, ``CONV_TILES``), ``attn_tiles.h``, the (BQ, BK,
    stages) of kernel #11 at each head width, from
    ``kernels/attention.py`` (``ATTN_TILES``), and ``ssd_tiles.h``, the
    chunk of kernel #13, the most heads a block walks and the columns
    of P it owns, from ``kernels/ssd_scan.py`` (``SSD_CHUNK``,
    ``SSD_HEADS``, ``SSD_PT``); each module plans its launches from the
    same table."""
    # imported late: these modules import us
    from .attention import ATTN_TILES
    from .conv2d import CONV_TILES, _CONV_BK
    from .qmatmul import A8_TILES, A8G_TILES, TILES, _A8_BK, _BK
    from .ssd_scan import SSD_CHUNK, SSD_HEADS, SSD_PT
    tiles = " ".join(f"REPRO_TILE({bm}, {bn})" for bm, bn in TILES)
    a8 = " ".join(f"REPRO_A8_TILE({bm}, {bn})" for bm, bn in A8_TILES)
    a8g = " ".join(f"REPRO_A8_TILE({bm}, {bn})" for bm, bn in A8G_TILES)
    conv = " ".join(f"REPRO_CONV_TILE({bm}, {bn})" for bm, bn in CONV_TILES)
    attn = " ".join(f"REPRO_ATTN_TILE({d}, {bq}, {bk}, {st})"
                    for d, (bq, bk, st) in sorted(ATTN_TILES.items()))
    return {"qmm_tiles.h": "#pragma once\n"
            f"#define REPRO_QMM_BK {_BK}\n"
            f"#define REPRO_QMM_TILES {tiles}\n"
            f"#define REPRO_A8_BK {_A8_BK}\n"
            f"#define REPRO_A8_TILES {a8}\n"
            f"#define REPRO_A8G_TILES {a8g}\n",
            "conv_tiles.h": "#pragma once\n"
            f"#define REPRO_CONV_BK {_CONV_BK}\n"
            f"#define REPRO_CONV_TILES {conv}\n",
            "attn_tiles.h": "#pragma once\n"
            f"#define REPRO_ATTN_TILES {attn}\n",
            "ssd_tiles.h": "#pragma once\n"
            f"#define REPRO_SSD_CHUNK {SSD_CHUNK}\n"
            f"#define REPRO_SSD_HEADS {SSD_HEADS}\n"
            f"#define REPRO_SSD_PT {SSD_PT}\n"}


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for name, text in sorted(generated_headers().items()):
        h.update(name.encode())
        h.update(text.encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> dict:
    """Compile every source in parallel, then link; returns build info."""
    nvcc = _nvcc()
    # objects go to a per-process directory and the library appears by
    # an atomic rename, so two processes building at once cannot mix
    # each other's half-written files
    work = out_dir / f"objs.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    for name, text in generated_headers().items():
        (work / name).write_text(text)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(work), "-c", str(src), "-o",
               str(obj)]
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
    """The kernels' shared library, built on first use; its entry points
    bound once, into ``_fns``."""
    global _lib
    if _lib is not None:
        return _lib
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
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
            _fns[fn] = f
        build_info.update(info, path=str(path))
        _lib = lib              # last: a reader that sees it sees _fns
        return lib


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``'s card (132 on an H100
    SXM), read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# The tensor-core kernels' planners (#1/#2 in kernels/conv2d.py, #7 and
# #8/#10 in kernels/qmatmul.py) share these rules. Every tile runs
# RESIDENT blocks an SM (csrc CV_RESIDENT, TC_RESIDENT), so the
# persistent grid, and the slots a split of K is sized to fill, are
# RESIDENT x the card's SMs (H100_SMS on an H100 SXM).
RESIDENT = 2
H100_SMS = 132


def pick_tile(tiles: tuple, n: int) -> tuple[int, int]:
    """The (BM, BN) of ``tiles`` for ``n`` output columns: of those whose
    columns exceed n by at most 25%, the one with the fewest column tiles
    (each reads the rows' operand once more), then the fewest columns;
    where none does (n < 16, or n = 20), the fewest columns, then the
    widest."""
    def cols(t):
        return -(-n // t[1]) * t[1]
    fits = [t for t in tiles if cols(t) <= 1.25 * n]
    if fits:
        return min(fits, key=lambda t: (-(-n // t[1]), cols(t)))
    return min(tiles, key=lambda t: (cols(t), -t[1]))


def split_k(tiles: int, k_tiles: int, slots: int, cap: int | None = None
            ) -> int:
    """Chunks of K for ``tiles`` output tiles of ``k_tiles`` slices each
    on a card that holds ``slots`` blocks at once: 1 where the tiles fill
    the slots; else at least enough chunks to fill them, at most twice
    that, none empty, and of those the split whose busiest block is
    shortest (its items times their slices plus two, for an item's
    epilogue and pipeline fill). With ``cap``, at most that many chunks
    (at least 1), rounded to the chunks that whole slices fill."""
    if tiles >= slots or k_tiles <= 1:
        return 1
    want = min(-(-slots // tiles), k_tiles)
    best = None
    for s in range(want, min(2 * want, k_tiles) + 1):
        per = -(-k_tiles // s)
        s = -(-k_tiles // per)                # chunks that hold slices
        if s < want:
            continue
        cost = -(-tiles * s // slots) * (per + 2)
        if best is None or cost < best[0]:
            best = (cost, s)
    splits = best[1]
    if cap is not None and splits > cap:
        per = -(-k_tiles // max(1, cap))
        splits = -(-k_tiles // per)
    return splits


# A float32 scratch buffer a (device, stream), shared by the kernels that
# need one (#1's split K, #13's chunk states): grown to the largest need
# and then reused (a fresh torch.empty took 8 µs of a split conv's 38 µs
# of host issue on the H100's host). A call's kernels write and read it
# in stream order; the slot's lock, held from the resize to the call's
# last launch, keeps another thread on the same stream from launching
# between them.
_scratch: dict = {}             # (device index, raw stream) -> [lock, buffer]
_scratch_lock = threading.Lock()


def scratch_slot(dev: torch.device, stream: int) -> list:
    """The [lock, buffer or None] of ``dev``'s stream ``stream``."""
    slot = _scratch.get((dev.index, stream))
    if slot is None:
        with _scratch_lock:
            slot = _scratch.setdefault((dev.index, stream),
                                       [threading.Lock(), None])
    return slot


def grown_scratch(slot: list, floats: int,
                  dev: torch.device) -> torch.Tensor:
    """``slot``'s buffer, made anew where it holds fewer than ``floats``
    (at least one); call it with the slot's lock held."""
    if slot[1] is None or slot[1].numel() < floats:
        slot[1] = torch.empty(max(floats, 1), device=dev,
                              dtype=torch.float32)
    return slot[1]


def check_no_grad(*tensors: torch.Tensor) -> None:
    """Raise if any operand requires grad: a wrapper launches the forward
    kernel only, and a silent fall back to the plain version would hide
    that. Training goes through ``ops`` (``ops.rmsnorm``/``mha``/
    ``ssd_scan``), whose autograd Functions (``kernels/autograd.py``)
    launch the kernel on detached operands."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                "a kernel wrapper takes no operand that requires grad: its "
                "backward is the plain version's, reached through ops."
                "rmsnorm/mha/ssd_scan and kernels/autograd.py (ROADMAP.md, "
                "training); call ops, or run under torch.inference_mode() "
                "or torch.no_grad()")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary (the
    kernels read 16 bytes at a time)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} does not start on a 16-byte boundary "
                         f"(an offset view?); make a fresh copy")


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  shape: tuple | None = None,
                  dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless ``t`` is what the kernels take: a contiguous tensor
    of one of ``dtypes`` (float32 by default; the quantized matmuls also
    take int8 and int16 codes) on ``device`` (with ``shape`` when given)
    whose elements an int32 index reaches."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}; expected one of "
                        f"{[str(d) for d in dtypes]}")
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
    on a CUDA error code.

    It runs on every kernel call, so it does only what a launch needs:
    the bound function from ``_fns``; the stream's raw handle
    (``torch._C._cuda_getCurrentRawStream``, what ``torch.cuda.
    current_stream(device).cuda_stream`` reads, without building a
    ``Stream``); and ``torch.cuda.device(device)`` entered only when the
    calling thread's current device is another (a kernel launches on the
    current device, so the stream must be that device's)."""
    if _lib is None:
        library()
    f = _fns[fn]
    idx = device.index
    if torch._C._cuda_getDevice() == idx:
        rc = f(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = f(*args, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")
