"""repro_torch.ft — failure injection and straggler detection for the
training loop (numpy-only copies of the JAX package's ``ft.failures`` and
``ft.stragglers``).  ``ft.elastic`` (survivor meshes and resharding) needs
the reference's ``sharding`` rules and has no meaning on one card; it is
not ported (README)."""
from .failures import FailureInjector
from .stragglers import StragglerMonitor

__all__ = ["FailureInjector", "StragglerMonitor"]
