"""repro_torch.ft — failure injection, straggler detection and elastic
re-meshing for the training loop: ``failures`` and ``stragglers`` are
numpy-only copies of the JAX package's, ``elastic`` rebuilds a smaller
mesh after failures and reshards a tree onto it with DTensor."""
from .elastic import reshard, survivor_mesh
from .failures import FailureInjector
from .stragglers import StragglerMonitor

__all__ = ["survivor_mesh", "reshard", "FailureInjector", "StragglerMonitor"]
