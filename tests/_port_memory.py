"""The memory a port test module leaves behind, released at its end.

Every ``tests/test_torch_*.py`` imports ``release_memory``, a
module-scoped autouse fixture. A test worker of a parallel run
(``pytest -n 6 --dist loadfile``) runs many modules in turn, and without
it holds what all of them compiled: the JAX package's jitted executables
stay cached for the life of the process (``jax.clear_caches`` drops
them), and the heap they freed stays with the process (``malloc_trim``
hands it back). ``test_torch_quant_compile.py`` alone on the CPU holds
3.3 GB at its end, 1.0 GB after the release.
"""
import ctypes
import gc
import sys

import pytest


def release() -> None:
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):       # not glibc: nothing to trim
        pass


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    yield
    release()
