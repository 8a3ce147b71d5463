"""MPC config schema loading (L7).

Copied from ``sde4mbrl_px4_tpu/io/config.py`` (numpy + PyYAML): the port
may not import the JAX package, whose ``__init__`` imports JAX.

The YAML schema is the reference's entire solver hyper-parameter surface
(SURVEY.md §2.10; ``launch/iris_sitl_traj_mpc.yaml``): model checkpoint
path, optional trajectory CSV, input box constraints, cost weights, horizon
discretization, particle count and the ``apg_mpc`` optimizer block.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import yaml

__all__ = ["load_yaml_config", "input_bounds_from_config"]

_DEFAULTS: Dict[str, Any] = {
    "enforce_ubound": True,
    "discount": 1.0,
    "num_particles": 1,
    "horizon": 20,
    "num_short_dt": 20,
    "short_step_dt": 0.05,
    "long_step_dt": 0.05,
}

# Every top-level key any consumer reads (reference schema, SURVEY.md §2.10,
# + this framework's documented extensions). Unknown keys WARN (typos like
# "antithetik" silently doing nothing is an operator footgun) but never
# fail — forward compatibility.
_KNOWN_KEYS = set(_DEFAULTS) | {
    "learned_model_params", "trajectory_path", "input_constr",
    "state_constr", "cost_params", "apg_mpc", "seed",
    # framework extensions (engine/mpc_loader.py)
    "antithetic", "initial_state_std", "warm_shift", "matmul_precision",
    "pallas_chunk", "solver", "mppi", "policy",
}


def load_yaml_config(path: str) -> Dict[str, Any]:
    """Load + validate an MPC YAML config; fills schema defaults."""
    path = os.path.expanduser(path)
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path} did not parse to a mapping")
    for k, v in _DEFAULTS.items():
        cfg.setdefault(k, v)
    for req in ("input_constr", "cost_params", "apg_mpc"):
        if req not in cfg:
            raise ValueError(f"config {path} missing required block {req!r}")
    unknown = sorted(k for k in cfg
                     if k not in _KNOWN_KEYS and not k.startswith("_"))
    if unknown:
        import warnings

        warnings.warn(
            f"config {os.path.basename(path)}: unknown key(s) {unknown} "
            "will be ignored (typo?)", stacklevel=2)
    n_u = len(cfg["input_constr"]["input_id"])
    if len(cfg["input_constr"]["input_bound"]) != n_u:
        raise ValueError("input_bound length must match input_id length")
    if len(np.atleast_1d(cfg["cost_params"]["uref"])) != n_u:
        raise ValueError("cost_params.uref length must match number of inputs")
    # Relative asset paths resolve against the config file's directory (the
    # reference resolves configs as ``config_dir + "/" + name``,
    # ``sde_control.py:161``; asset paths there are absolute/home-anchored).
    base = os.path.dirname(os.path.abspath(path))
    for key in ("learned_model_params", "trajectory_path"):
        p = cfg.get(key)
        if p:
            p = os.path.expanduser(p)
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            cfg[key] = p
    cfg["_config_path"] = path
    return cfg


def input_bounds_from_config(cfg: Dict[str, Any]):
    """(lb, ub) arrays from ``input_constr.input_bound``
    (``iris_sitl_traj_mpc.yaml:8-11``)."""
    b = np.asarray(cfg["input_constr"]["input_bound"], np.float32)
    return b[:, 0], b[:, 1]
