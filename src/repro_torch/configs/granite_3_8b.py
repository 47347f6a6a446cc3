"""Assigned architecture config — see registry.py for the
exact figures and provenance notes."""
from .registry import GRANITE_3_8B as CONFIG  # noqa: F401
from .registry import reduced as _reduced


def smoke_config():
    return _reduced(CONFIG.name)
