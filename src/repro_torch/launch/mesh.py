"""Meshes: named axes over a grid of positions.

The counterpart of the JAX package's ``launch/mesh.py`` for a program
that runs in one process. A ``Mesh`` lays positions out on named axes
(``("data", "model")``, ``("stage",)``); each position names a
``torch.device``, and several positions may name the same device: that
runs a sharded or pipelined path on one card (or on the CPU) with every
transfer between positions still made and labelled
(``roofline/trace.py``). A mesh with no devices bound is a plan only
(``make_production_mesh``).

Functions, not module constants: importing this module never touches
device state.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ..device import cuda_devices


class Mesh:
    """Named axes over positions. ``shape`` maps each axis to its size,
    in order (as ``jax.sharding.Mesh.shape``); ``devices`` is an object
    array of ``torch.device`` of that shape, or None for a mesh that is
    only planned."""

    def __init__(self, devices, axis_names, shape=None):
        self.axis_names = tuple(axis_names)
        if devices is None:
            if shape is None or len(shape) != len(self.axis_names):
                raise ValueError("a mesh without devices needs its shape")
            self.devices = None
            sizes = tuple(int(s) for s in shape)
        else:
            arr = np.array(devices, dtype=object)
            if shape is not None:
                arr = arr.reshape(tuple(shape))
            flat = arr.reshape(-1)
            for i, d in enumerate(flat):
                flat[i] = torch.device(d)
            if arr.ndim != len(self.axis_names):
                raise ValueError(f"mesh of {arr.ndim} dimensions, axes "
                                 f"{self.axis_names}")
            self.devices = arr
            sizes = arr.shape
        self.shape = OrderedDict(zip(self.axis_names, sizes))

    def device_list(self) -> list[torch.device]:
        """The positions' devices in row-major order."""
        if self.devices is None:
            raise ValueError("this mesh is a plan: no devices are bound")
        return list(self.devices.reshape(-1))

    def coords(self, position: int) -> dict[str, int]:
        """The coordinate of row-major ``position`` on every axis."""
        return {a: int(i) for a, i in zip(self.axis_names, np.unravel_index(
            position, tuple(self.shape.values())))}

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        where = "planned" if self.devices is None else \
            "on " + ",".join(sorted({str(d) for d in self.device_list()}))
        return f"Mesh({axes}; {where})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16×16 (``data``, ``model``) mesh, or 2×16×16 with ``pod``,
    with no devices bound: a plan for the analytic roofline and the
    sharding rules, which read only its axis sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape=shape)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: the visible CUDA
    devices, ``RuntimeError`` without one). Raises ``ValueError`` when
    there are fewer devices than positions, as ``jax.make_mesh`` does; an
    explicit list may name a device more than once."""
    shape = tuple(int(s) for s in shape)
    devs = cuda_devices() if devices is None else list(devices)
    n = math.prod(shape)
    if len(devs) < n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"{len(devs)} given")
    return Mesh(devs[:n], axes, shape=shape)
