"""Assigned architecture config — see registry.py for the
exact figures and provenance notes."""
from .registry import MAMBA2_130M as CONFIG  # noqa: F401
from .registry import reduced as _reduced


def smoke_config():
    return _reduced(CONFIG.name)
