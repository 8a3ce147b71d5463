"""Model checkpoint IO (L1).

``load_params`` is copied from ``sde4mbrl_px4_tpu/models/params_io.py``:
checkpoints are pickles of ``{"meta": {...}, "params": <tree of numpy
arrays>}``, so ``configs/models/*.pkl`` load without JAX.
:func:`params_from_numpy` turns that tree (the JAX package's parameter
pytree, on-disk format) into the port's parameters: the same nested dict
with fp32 tensors on ``device``.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["load_params", "params_from_numpy"]


def load_params(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns ``(params, meta)``. Accepts both the framework's layout and a
    bare parameter tree (meta defaults to {}). Only open checkpoints this
    project wrote: unpickling runs code."""
    path = os.path.expanduser(path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if isinstance(blob, dict) and "params" in blob:
        return blob["params"], blob.get("meta", {})
    return blob, {}


def params_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Nested dict of numpy arrays/scalars -> same nesting of fp32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)
