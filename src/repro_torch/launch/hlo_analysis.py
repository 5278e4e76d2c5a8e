"""The roofline terms — the port of the JAX package's
``launch/hlo_analysis.py``, less ``collective_bytes``.

The reference's ``collective_bytes`` sums the collectives of XLA's
partitioned HLO text.  The port compiles no HLO, and the reference's
dry-run records that census only for transparency: its roofline takes
collective bytes from the cost model (``launch/costmodel.py``), as the
port's does.
"""
from __future__ import annotations

from typing import Dict


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, *, peak_flops: float,
                   hbm_bw: float, link_bw: float) -> Dict[str, float]:
    """The three §Roofline terms, in seconds (per step, per device)."""
    compute = flops_per_dev / peak_flops
    memory = bytes_per_dev / hbm_bw
    collective = coll_bytes_per_dev / link_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    bound = max(compute, memory, collective)
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms
