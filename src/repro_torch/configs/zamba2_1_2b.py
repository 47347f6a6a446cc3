"""Assigned architecture config — see registry.py for the
exact figures and provenance notes."""
from .registry import ZAMBA2_1_2B as CONFIG  # noqa: F401
from .registry import reduced as _reduced


def smoke_config():
    return _reduced(CONFIG.name)
