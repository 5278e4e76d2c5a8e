"""repro_torch.checkpoint — atomic step checkpoints in the JAX package's
format (the port of its ``checkpoint``)."""
from .checkpointer import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
