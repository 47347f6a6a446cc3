"""Collective traffic read from a ``torch.profiler`` trace.

The counterpart of the JAX package's ``roofline/hlo.py``, which sums
the result sizes of the collectives in compiled HLO text. The port has
no compiled program to read: its multi-position paths (the
tensor-parallel YOLO forward, ``dist/sharding.py``; the streaming
pipeline, ``core/pipeline.py``) move tensors between positions
themselves, and label every such transfer with a ``record_function``
range (``transfer``) that names its kind and its bytes. This module
reads those ranges back.

Kinds are the JAX package's (``all-gather``, ``collective-permute``,
``all-reduce``, ...). A range's bytes are the size of what the
collective produces at one position, as HLO's result shape is in the
per-device program: an all-gather's gathered tensor, a permute's
buffer. A transfer counts even when both positions name one device, as
HLO lists an op wherever it is placed.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Iterable

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

PREFIX = "collective::"


def label(kind: str, nbytes: int) -> str:
    """The range name of one transfer: ``collective::<kind>::<bytes>``."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}: {COLLECTIVES}")
    return f"{PREFIX}{kind}::{int(nbytes)}"


@contextlib.contextmanager
def transfer(kind: str, nbytes: int):
    """Label the transfer run inside the block (a ``record_function``
    range; a no-op beyond its name when no profiler records)."""
    with torch.profiler.record_function(label(kind, nbytes)):
        yield


def _names(trace) -> Iterable[str]:
    """Event names of a ``torch.profiler.profile`` (after its run), of
    its ``events()`` list, or of an iterable of names."""
    events = trace.events() if hasattr(trace, "events") else trace
    for e in events:
        yield e if isinstance(e, str) else e.name


def _parse(name: str):
    if not name.startswith(PREFIX):
        return None
    kind, _, nbytes = name[len(PREFIX):].partition("::")
    return kind, int(nbytes)


def collective_bytes(trace) -> dict[str, int]:
    """Bytes by collective kind, plus ``total``."""
    out: dict[str, int] = defaultdict(int)
    for name in _names(trace):
        got = _parse(name)
        if got is not None:
            out[got[0]] += got[1]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)


def collective_count(trace) -> int:
    """The number of labelled transfers."""
    return sum(1 for name in _names(trace) if _parse(name) is not None)
