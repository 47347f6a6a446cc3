"""``repro_torch.check`` — the compile-time design-rule checker.

Thin CLI package over :mod:`repro_torch.core.check`, copied from the JAX
package's ``repro/check``. ``python -m repro_torch.check --model yolov8n
--bits mixed`` compiles a builder with the port and reports every
``SAT0xx`` finding; ``--selftest`` runs the mutation self-test.
"""
from ..core.check import (  # noqa: F401
    DIAGNOSTICS, ERROR, INFO, WARN, CheckError, CheckResult,
    Diagnostic, DesignContext, Finding, check_accelerator, check_design,
    check_graph, required_fifo_depths, run_checkers, selftest,
)
