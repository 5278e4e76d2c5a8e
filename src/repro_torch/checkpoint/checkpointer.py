"""Atomic, resumable checkpointing — the port of the JAX package's
``checkpoint/checkpointer.py``, on the same format, so that a checkpoint
written by either package restores in the other.

Layout per step:

    <dir>/step_000123/
        manifest.json         # flat keys → shape and dtype, host count
        shard_00000.npz       # this host's leaves, flat key → raw bytes

* **Atomicity** — writes go to ``step_N.tmp/`` and are renamed into place
  only after the manifest lands; a crash mid-write never corrupts the
  latest complete checkpoint.
* **Raw bytes** — each leaf is stored as its bytes (uint8) and rebuilt from
  the manifest's shape and dtype, so bf16 leaves round-trip.  numpy has no
  bfloat16 without ``ml_dtypes`` (which the card's machine lacks), so a
  bf16 leaf is written from and rebuilt into torch through an int16 view.
* **Keys** — dicts by key, tuples and lists by index, named tuples (the
  AdamW state) by field: ``0/embed``, ``1/step``, ``1/m/layers/ln1``.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_flatten(getattr(tree, f), f"{prefix}{f}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_like(template: Any, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)) and not hasattr(template, "_fields"):
        seq = [_unflatten_like(v, flat, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return type(template)(seq)
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_like(getattr(template, f), flat, f"{prefix}{f}/")
            for f in template._fields])
    leaf = flat[prefix.rstrip("/")]
    device = template.device if isinstance(template, torch.Tensor) else "cpu"
    return leaf.to(device)


def _to_numpy(x) -> tuple:
    """(array of the leaf's bytes in its own layout, dtype name)."""
    t = torch.as_tensor(x).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A leaf from its bytes (``raw``, a fresh array ``np.load`` made)."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape)) \
            .view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))


def latest_step(directory: str | Path) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 host_index: int = 0, num_hosts: int = 1):
        self.dir = Path(directory)
        self.keep = keep
        self.host = host_index
        self.num_hosts = num_hosts
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, tree: Any) -> Path:
        flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
        final = self.dir / f"step_{step:06d}"
        tmp = self.dir / f"step_{step:06d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {k: np.ascontiguousarray(a).view(np.uint8).reshape(-1)
                  for k, (a, _) in flat.items()}
        np.savez(tmp / f"shard_{self.host:05d}.npz", **arrays)
        manifest = {
            "step": step,
            "num_hosts": self.num_hosts,
            "keys": {k: {"shape": list(a.shape), "dtype": dt}
                     for k, (a, dt) in flat.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self._gc()
        return final

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """(tree shaped as ``template``, step): each leaf a tensor of the
        manifest's dtype on its template leaf's device."""
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:06d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for p in sorted(d.glob("shard_*.npz")):
            with np.load(p) as z:
                for k in z.files:
                    flat[k] = z[k]
        missing = set(manifest["keys"]) - set(flat)
        if missing:
            raise IOError(f"checkpoint step {step} incomplete: {missing}")
        typed = {k: _from_bytes(flat[k], meta["dtype"], meta["shape"])
                 for k, meta in manifest["keys"].items()}
        return _unflatten_like(template, typed), step

    def _gc(self):
        steps = sorted(p for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for p in steps[: -self.keep]:
            shutil.rmtree(p)
