"""repro_torch — the Dodoor reproduction on PyTorch and CUDA.

A second package beside the JAX reference ``repro``, with the same layout
and names so each module has an obvious counterpart.  It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``.

Ported so far: the batched decision-block driver and the sequential
oracle (:func:`repro_torch.sim.simulate`, ``mode="batched"`` and
``"sequential"``) for all five policies — ``random``, ``dodoor``,
``one_plus_beta`` and the probing baselines ``pot`` and ``prequal`` —
with server dynamics (outages, churn, stragglers, store outages), task
graphs and retries; the streaming decision service over the block step
(:mod:`repro_torch.serve`); the scenario engine
(:mod:`repro_torch.sim.scenarios`) and its arrival
processes, decision-trace telemetry and per-scheduler cache faults, the
grid planners (``run_study``, ``simulate_many``,
``simulate_hierarchical``, ``run_scenario_grid``) and the mean-field
predictor, the inputs (clusters and the FunctionBench/Azure traces), the
Algorithm-1 core with the PoT and Prequal policies and the
balls-into-bins theory, a bit-exact port of JAX's partitionable threefry
PRNG with its exponential and integer draws, the LM substrate's dense and
Mamba-2 models, and every Pallas kernel of the reference as hand-written
CUDA for Hopper (``kernels/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise.  Importing the
package itself imports no torch, so the numpy-only :mod:`repro_torch.obs`
stays free of a device runtime.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ._device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
