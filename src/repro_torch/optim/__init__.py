"""repro_torch.optim — AdamW with global-norm clipping, the cosine
schedule and int8 gradient compression: the port of the JAX package's
``optim``."""
from .adamw import AdamWState, adamw_init, adamw_update
from .schedule import cosine_schedule
from .compression import compress_grads, decompress_grads, CompressionState

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_grads", "decompress_grads", "CompressionState"]
