"""Cluster specifications — the paper's 101-node CloudLab testbed (Table 2).

100 server nodes across four heterogeneous types (the 101st node hosts the
schedulers + data store and is not a placement target). Capacities are
[CPU cores, memory MB] per §6.1 (disk ignored).

A numpy-only copy of ``repro.sim.cluster``, kept array-equal to it by the port's
tests (the port imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Node-type order used everywhere a per-type array appears.
NODE_TYPES = ("m510", "xl170", "c6525-25g", "c6620")

#: Hard engine ceiling on per-node cores — the engine's per-core
#: unit-resource table is [n, CMAX] (c6620, Table 2, is the biggest node).
#: ``make_scaled`` clips to it; ``engine`` imports it.
CMAX = 28


@dataclass(frozen=True)
class NodeType:
    name: str
    cores: int
    mem_mb: int
    ghz: float
    count: int


# Table 2, server rows.
TESTBED_TYPES = (
    NodeType("m510", cores=8, mem_mb=64_000, ghz=2.0, count=40),
    NodeType("xl170", cores=10, mem_mb=64_000, ghz=2.4, count=25),
    NodeType("c6525-25g", cores=16, mem_mb=128_000, ghz=3.0, count=18),
    NodeType("c6620", cores=28, mem_mb=128_000, ghz=2.1, count=17),
)


@dataclass(frozen=True)
class ClusterSpec:
    """A concrete server fleet.

    C:         [n, 2] float32 capacities (cores, MB).
    node_type: [n]    int32 index into ``type_names``.
    type_names: tuple of node-type names (len T).
    """

    C: np.ndarray
    node_type: np.ndarray
    type_names: tuple

    @property
    def num_servers(self) -> int:
        return self.C.shape[0]

    @property
    def num_types(self) -> int:
        return len(self.type_names)

    def type_capacity(self) -> np.ndarray:
        """[T, 2] capacity per node type (first instance of each)."""
        out = np.zeros((self.num_types, self.C.shape[1]), np.float32)
        for t in range(self.num_types):
            idx = np.argmax(self.node_type == t)
            out[t] = self.C[idx]
        return out


def make_testbed(scale: float = 1.0, interleave: bool = True) -> ClusterSpec:
    """The paper's 100-server fleet; ``scale`` shrinks/grows each type count
    proportionally (≥1 node per type) for smoke tests and scale studies.

    ``interleave`` shuffles node ordering deterministically so that uniform
    random candidate sampling is not correlated with node type blocks.
    """
    C_rows, types = [], []
    for t_idx, nt in enumerate(TESTBED_TYPES):
        cnt = max(1, round(nt.count * scale))
        for _ in range(cnt):
            C_rows.append((nt.cores, nt.mem_mb))
            types.append(t_idx)
    C = np.asarray(C_rows, np.float32)
    node_type = np.asarray(types, np.int32)
    if interleave:
        rng = np.random.RandomState(0)
        perm = rng.permutation(len(types))
        C, node_type = C[perm], node_type[perm]
    return ClusterSpec(C=C, node_type=node_type,
                       type_names=tuple(nt.name for nt in TESTBED_TYPES))


def make_scaled(n: int, het: float = 1.0, capacity_skew: float = 0.0,
                type_mix: tuple | None = None, seed: int = 0,
                interleave: bool = True) -> ClusterSpec:
    """A parameterized heterogeneous fleet of ``n`` servers — the Table-2
    testbed generalized to the scales the mean-field / balls-into-bins
    results speak about (n up to ~10⁴ and beyond).

    Parameters
    ----------
    n:
        Fleet size (any positive int; the paper's testbed is ``n=100``).
    het:
        Heterogeneity dial in [0, 1].  Per-type capacities are interpolated
        between the mix-weighted fleet mean (``het=0`` — every server
        identical, the classic homogeneous balls-into-bins assumption) and
        the full Table-2 spread (``het=1``).
    capacity_skew:
        ≥ 0 — stretches each type's deviation from the fleet mean by
        ``(1 + capacity_skew)`` before the ``het`` interpolation, widening
        the capacity spread beyond Table 2's.  Cores clip to the engine's
        per-node ceiling (28) and ≥ 1; memory to ≥ 1 GB.
    type_mix:
        Fraction of the fleet per node type, aligned with
        :data:`NODE_TYPES` (defaults to Table 2's 40/25/18/17).  Node
        counts follow the mix via a highest-averages (D'Hondt) allocation,
        which is *house monotone*: growing ``n`` only ever adds nodes, so
        total fleet capacity is strictly increasing in ``n``.
    seed / interleave:
        As :func:`make_testbed` — deterministic node-order shuffle so
        uniform candidate sampling is uncorrelated with type blocks.

    ``make_scaled(100, het=1.0)`` reproduces the Table-2 type counts and
    capacities exactly (in a different node order).
    """
    if n < 1:
        raise ValueError(f"n={n} must be ≥ 1")
    if not 0.0 <= het <= 1.0:
        raise ValueError(f"het={het} must be in [0, 1]")
    if capacity_skew < 0.0:
        raise ValueError(f"capacity_skew={capacity_skew} must be ≥ 0")
    T = len(TESTBED_TYPES)
    mix = np.asarray(type_mix if type_mix is not None
                     else [t.count for t in TESTBED_TYPES], np.float64)
    if mix.shape != (T,) or (mix < 0).any() or mix.sum() <= 0:
        raise ValueError(f"type_mix must be {T} non-negative fractions")
    mix = mix / mix.sum()

    # Highest-averages (D'Hondt) seat allocation: house monotone in n.
    counts = np.zeros(T, np.int64)
    for _ in range(n):
        counts[np.argmax(mix / (counts + 1))] += 1

    base = np.array([[t.cores, t.mem_mb] for t in TESTBED_TYPES], np.float64)
    mean = mix @ base                                   # [2] fleet mean
    cap = mean + het * (base - mean) * (1.0 + capacity_skew)
    cores = np.clip(np.round(cap[:, 0]), 1, CMAX)
    mem = np.clip(np.round(cap[:, 1]), 1000, None)

    node_type = np.repeat(np.arange(T, dtype=np.int32), counts)
    C = np.stack([cores[node_type], mem[node_type]], axis=1).astype(np.float32)
    if interleave:
        rng = np.random.RandomState(seed)
        perm = rng.permutation(n)
        C, node_type = C[perm], node_type[perm]
    return ClusterSpec(C=C, node_type=np.ascontiguousarray(node_type),
                       type_names=tuple(t.name for t in TESTBED_TYPES))


def make_homogeneous(n: int, cores: int = 16, mem_mb: int = 64_000) -> ClusterSpec:
    """A homogeneous fleet (the classic balls-into-bins assumption) for
    ablations isolating the heterogeneity effect."""
    C = np.tile(np.array([[cores, mem_mb]], np.float32), (n, 1))
    return ClusterSpec(C=C, node_type=np.zeros(n, np.int32),
                       type_names=("uniform",))
