"""repro_torch — the Dodoor reproduction on PyTorch and CUDA.

A second package beside the JAX reference ``repro``, with the same layout
and names so each module has an obvious counterpart.  It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``.

Ported so far: the batched decision-block driver for the ``random``,
``dodoor`` and ``one_plus_beta`` policies without dynamics
(:func:`repro_torch.sim.simulate`), its inputs (clusters and the
FunctionBench/Azure traces), the Algorithm-1 core, a bit-exact port of
JAX's partitionable threefry PRNG, and the sparse-gather decision kernel
as hand-written CUDA for Hopper (``kernels/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
