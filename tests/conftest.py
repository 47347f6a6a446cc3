"""Shared fixtures + a minimal ``hypothesis`` fallback.

The property-based suites (test_ir_dse / test_optim / test_quant) use
hypothesis, which is not part of the baked toolchain image. Rather than
skipping whole modules, this conftest installs a tiny API-compatible
shim (seeded random sampling, no shrinking) when the real library is
absent, so every test still collects and runs. With hypothesis
installed, the real library is used untouched.
"""
import functools
import inspect
import random
import sys
import types
import warnings

import numpy as np
import pytest

_SHIM_WARNING = (
    "hypothesis is NOT installed: property-based suites are running on "
    "the conftest shim (seeded sampling, 10 examples per property, no "
    "shrinking). This is NOT the full property suite — install "
    "hypothesis (CI does) for real coverage.")

try:
    import hypothesis  # noqa: F401
except ImportError:                                    # pragma: no branch
    _SHIM_SEED = 0
    _SHIM_MAX_EXAMPLES = 10        # cap: CI speed over exhaustiveness

    class _Strategy:
        def __init__(self, sample):
            self._sample = sample

        def example(self, rng):
            return self._sample(rng)

    def _integers(lo, hi):
        return _Strategy(lambda rng: rng.randint(lo, hi))

    def _floats(lo, hi):
        if lo > 0 and hi / lo >= 100.0:    # wide positive range: log-uniform
            import math
            return _Strategy(lambda rng: math.exp(
                rng.uniform(math.log(lo), math.log(hi))))
        return _Strategy(lambda rng: rng.uniform(lo, hi))

    def _sampled_from(seq):
        items = list(seq)
        return _Strategy(lambda rng: items[rng.randrange(len(items))])

    class _Draw:
        def __init__(self, rng):
            self._rng = rng

        def __call__(self, strategy):
            return strategy.example(self._rng)

    def _composite(fn):
        @functools.wraps(fn)
        def builder(*args, **kwargs):
            return _Strategy(lambda rng: fn(_Draw(rng), *args, **kwargs))
        return builder

    def _settings(max_examples=_SHIM_MAX_EXAMPLES, deadline=None, **_kw):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    def _given(*strategies, **kw_strategies):
        def deco(fn):
            def wrapper():
                n = min(getattr(wrapper, "_shim_max_examples",
                                _SHIM_MAX_EXAMPLES), _SHIM_MAX_EXAMPLES)
                rng = random.Random(_SHIM_SEED)
                for _ in range(n):
                    vals = [s.example(rng) for s in strategies]
                    kvals = {k: s.example(rng)
                             for k, s in kw_strategies.items()}
                    fn(*vals, **kvals)

            # No functools.wraps: pytest must see a zero-arg signature,
            # not the strategy parameters (it would read them as fixtures).
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _st.composite = _composite

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_shim__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_report_header(config):
    if getattr(sys.modules.get("hypothesis"), "__is_shim__", False):
        return f"WARNING: {_SHIM_WARNING}"
    return None


def pytest_configure(config):
    if getattr(sys.modules.get("hypothesis"), "__is_shim__", False):
        # Visible in the warnings summary too, so a local run can never
        # silently masquerade as the full property suite.
        warnings.warn(_SHIM_WARNING, UserWarning, stacklevel=2)
    config.addinivalue_line("markers", "slow: heavier end-to-end tests")
    config.addinivalue_line(
        "markers", "bench: benchmark smoke runs (fusion ablation at tiny "
        "image sizes) — deselected from the tier-1 default run; select "
        "explicitly with `-m bench`")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "card with `-m gpu`)")


def pytest_collection_modifyitems(config, items):
    # Keep the default run (and `-m "not slow"`) fast: bench-marked
    # smokes run only when the mark expression names `bench`.
    if "bench" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(reason="bench smoke: run with -m bench")
    for item in items:
        if "bench" in item.keywords:
            item.add_marker(skip)
