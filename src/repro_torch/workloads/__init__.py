"""repro_torch.workloads — the Azure VM trace (§6.2) and FunctionBench
(§6.3) synthesizers, numpy-only copies of the reference's."""
from . import azure, functionbench

__all__ = ["azure", "functionbench"]
