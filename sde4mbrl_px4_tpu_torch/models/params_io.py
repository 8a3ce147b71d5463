"""Model checkpoint IO (L1).

``load_params`` and ``save_params`` follow ``sde4mbrl_px4_tpu/models/
params_io.py`` (``:28-48``): checkpoints are pickles of ``{"meta": {...},
"params": <tree of numpy arrays>}``, so ``configs/models/*.pkl`` load
without JAX, and each package loads the checkpoints the other writes.
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

__all__ = ["load_params", "params_from_numpy", "params_to_numpy", "save_params"]


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_numpy`: nested dicts of tensors
    (any device) or numpy values -> the same nesting of numpy arrays, each
    leaf as ``np.asarray`` makes it (the original maps ``np.asarray`` over
    its pytree)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_params(path: str, params: Dict[str, Any],
                meta: Dict[str, Any] | None = None) -> None:
    """Pickle ``{"meta": meta, "params": params as numpy}`` to ``path``
    (parent directories made), the original's schema."""
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"meta": dict(meta or {}), "params": params_to_numpy(params)}, f)


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
