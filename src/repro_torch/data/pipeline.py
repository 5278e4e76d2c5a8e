"""Deterministic synthetic token pipeline — the port of the JAX package's
``data/pipeline.py``, token for token.

* **Step-indexed determinism** — ``batch(i)`` is a pure function of
  (seed, i), so a restarted job resumes mid-epoch with no state file;
* **Host-sharded** — each data-parallel host materialises only its slice;
* **Learnable structure** — tokens follow a stationary order-2 Markov chain
  (fixed random transition logits), so the CE loss of a training run has a
  floor below uniform entropy and "loss goes down" is a meaningful test.

The reference draws each row's next state with ``jax.random.categorical``
inside a scan over positions.  That draw is ``argmax(logits[state] +
gumbel(k_t))``, and the Gumbel noise of step t depends on its key only, so
the port draws a row's noise for every position in one call
(``random.gumbel``, with XLA's ``log`` replayed) on the pipeline's device
and runs only the state chain as a loop over positions, on the host
(numpy float32 adds and a first-index argmax, as ``jnp.argmax``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import random as jr
from .._device import resolve_device


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64           # Markov states (vocab buckets)
    #: Where the noise is drawn and the batch lands: the card unless the
    #: caller passes "cpu".  The tokens are the same on either.
    device: Optional[str] = None

    def _chain(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        # Sparse-ish row-stochastic transitions over states.
        return (rng.randn(self.n_states, self.n_states) * 2.0).astype(
            np.float32)

    def batch(self, step: int, *, host_index: int = 0, num_hosts: int = 1):
        """(tokens, labels) for ``step`` as int32 tensors [b_local,
        seq_len]; host gets rows [host_index·b_local, (host_index+1)·
        b_local)."""
        dev = resolve_device(self.device)
        b_local = self.global_batch // num_hosts
        key = jr.fold_in(jr.PRNGKey(self.seed, device=dev), step)
        key = jr.fold_in(key, host_index)
        ks = jr.split(jr.split(key, b_local), self.seq_len + 1)
        s0 = jr.randint(ks[:, 0], (), 0, self.n_states)
        noise = jr.gumbel(ks[:, 1:], (self.n_states,)).cpu().numpy()
        logits = self._chain()
        state = s0.cpu().numpy().astype(np.int64)
        states = np.empty((b_local, self.seq_len), np.int32)
        for t in range(self.seq_len):
            state = np.argmax(noise[:, t] + logits[state], axis=-1)
            states[:, t] = state
        # Map states onto the vocab (stride so ids spread the range).
        stride = max(1, self.vocab // self.n_states)
        tokens = (states * stride) % self.vocab
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        return {"tokens": torch.from_numpy(tokens).to(dev),
                "labels": torch.from_numpy(labels).to(dev)}


def make_batch_iterator(vocab: int, seq_len: int, global_batch: int,
                        seed: int = 0, start_step: int = 0,
                        host_index: int = 0, num_hosts: int = 1,
                        device=None):
    """Infinite iterator of (step, batch) — resumable from ``start_step``."""
    src = SyntheticLM(vocab, seq_len, global_batch, seed, device=device)
    step = start_step
    while True:
        yield step, src.batch(step, host_index=host_index,
                              num_hosts=num_hosts)
        step += 1
