"""repro_torch.data — the synthetic token pipeline (the port of the JAX
package's ``data``)."""
from .pipeline import SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "make_batch_iterator"]
