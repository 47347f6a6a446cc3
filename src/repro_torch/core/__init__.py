# Public compiler API of the port: one IR (ir.Graph), a pass pipeline
# over it (passes.py), compile(model_or_graph, CompileConfig,
# torch_device=...) producing an Accelerator whose executor is generated
# from the rewritten IR (codegen.py), and the design-rule checker.
from .check import (CheckError, CheckResult, DIAGNOSTICS,  # noqa: F401
                    Finding, check_accelerator, check_design,
                    check_graph, required_fifo_depths)
from .toolflow import Accelerator, CompileConfig, compile  # noqa: F401
