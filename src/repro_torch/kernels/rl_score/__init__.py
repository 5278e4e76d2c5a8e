"""Batched Eq.-1 RL score matrix K6: CUDA kernel (``kernel.py`` launches
``csrc/rl_score.cu``), wrapper (``ops.py``) and plain-torch version
(``ref.py``) — the same three layers as the JAX reference."""
from .ops import LAUNCHES, rl_score_matrix
from .ref import rl_score_matrix_ref

__all__ = ["LAUNCHES", "rl_score_matrix", "rl_score_matrix_ref"]
