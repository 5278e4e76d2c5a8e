"""repro_torch.train — the train, prefill and serve steps (the port of the
JAX package's ``train``)."""
from .steps import (abstract_train_state, chunked_ce_loss, init_train_state,
                    loss_and_grads, make_prefill_step, make_serve_step,
                    make_train_step)

__all__ = ["abstract_train_state", "chunked_ce_loss", "init_train_state",
           "loss_and_grads", "make_serve_step", "make_train_step",
           "make_prefill_step"]
