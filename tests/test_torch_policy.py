"""Port parity, the policy solver family: ``models/policy.py`` and the
``solver: policy`` routes of the loader, on the CPU (the plain versions)
against the JAX package.

- ``featurize`` on random states and batches (unnormalised quaternions,
  both signs of q0, a q0 of exactly 0) and ``policy_apply`` on a JAX
  ``init_policy`` tree carried across, atol 1e-6; ``init_policy``'s shapes
  and hover head;
- the four shipped checkpoints through the pure policy's ``mpc_fn``
  against JAX's over 3 chained solves: u 1e-5, cost rtol 2e-5, ``x_evol``
  rtol 1e-5 (``tests/test_apg_kernel.py:199``);
- ``replay_solver_family("policy")`` on JAX's ``init_policy(PRNGKey(0))``
  weights (a checkpoint the test writes) against the committed
  ``family_policy_trace.npz`` at 1e-4 (``tests/test_goldens_flagship.py:127``);
- the ``refine_iters`` hybrid: the first solve in lockstep with JAX's XLA
  solve (rtol 2e-4 / atol 2e-5, equal ``num_steps``), the cold-start select,
  and ``iter_budget`` capping it at ``min(refine_iters, budget)`` at H = 20
  (``tests/test_deadline.py:268-293``, whose H = 5 would miss the committed
  preconditioner);
- the loader's refusals (the original's, ``engine/mpc_loader.py:374-433``).
(The closed loop with ``--solver policy``: ``tests/test_torch_sim.py``.)
"""
import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.core.frames import enu2ned as j_enu2ned
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make_mpc
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load_yaml
from sde4mbrl_px4_tpu.models import policy as jpol
from sde4mbrl_px4_tpu.ops.rollout import rollout_mean as j_rollout_mean
from sde4mbrl_px4_tpu_torch.core.frames import enu2ned
from sde4mbrl_px4_tpu_torch.core.types import hover_state
from sde4mbrl_px4_tpu_torch.engine import goldens as G
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.models import policy as tpol
from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO

T = torch.from_numpy
CHECKPOINTS = [(v, k) for v in ("iris", "hexa") for k in ("traj", "posctrl")]


def random_states(rs, lead):
    """States with unnormalised quaternions of either sign of q0, one of
    them with q0 exactly 0, and references around them."""
    x = rs.randn(*lead, 13).astype(np.float32)
    x[..., 6:10] *= rs.uniform(0.5, 2.0, lead + (1,)).astype(np.float32)
    x.reshape(-1, 13)[0, 6] = 0.0
    return x


def write_checkpoint(path, tree, kind=jpol.POLICY_KIND):
    with open(path, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, tree), "meta": {"kind": kind}}, f)
    return str(path)


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_featurize_matches_jax(lead):
    rs = np.random.RandomState(len(lead))
    H, n_u = 6, 4
    x = random_states(rs, lead)
    x_ref = rs.randn(*lead, H + 1, 13).astype(np.float32)
    x_ref[..., 6:10] /= np.linalg.norm(x_ref[..., 6:10], axis=-1, keepdims=True)
    u_prev = rs.rand(*lead, n_u).astype(np.float32)
    f = jpol.featurize
    for _ in lead:
        f = jax.vmap(f)
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(x_ref), jnp.asarray(u_prev)))
    got = tpol.featurize(T(x), T(x_ref), T(u_prev)).numpy()
    assert got.shape == lead + (tpol.policy_feat_dim(H, n_u),) == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("H, n_u, hidden", [(20, 4, (32, 24)), (5, 6, (16,))])
def test_policy_apply_matches_jax(H, n_u, hidden):
    """A JAX ``init_policy`` tree with its head drawn at full scale (so the
    plan depends on the features), carried across: the plans agree."""
    lb, ub = np.full(n_u, 1e-4, np.float32), np.ones(n_u, np.float32)
    tree = jpol.init_policy(jax.random.PRNGKey(H), H, n_u, lb, ub,
                            np.full(n_u, 0.6, np.float32), hidden=hidden)
    last = f"w{len(hidden)}"
    tree["net"][last] = tree["net"][last] * np.float32(1e3)
    feats = np.random.RandomState(n_u).randn(7, tpol.policy_feat_dim(H, n_u)).astype(np.float32)
    ref = np.asarray(jpol.policy_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats),
                                       jnp.asarray(lb), jnp.asarray(ub)))
    net = tpol.policy_from_numpy(tree)
    assert (net.H, net.n_u) == (H, n_u) and isinstance(net.H, int)
    got = tpol.policy_apply(net, T(feats), T(lb), T(ub)).numpy()
    assert got.shape == (7, H, n_u)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.ptp(got) > 0.1


def test_init_policy_shapes_and_hover_head():
    """The port's init: the original's layer sizes and head bias (the hover
    logit of uref tiled H times), so the untrained plan is ~uref."""
    H, n_u = 20, 4
    lb, ub = np.full(n_u, 1e-4, np.float32), np.ones(n_u, np.float32)
    uref = np.array([0.55, 0.6, 0.65, 0.7], np.float32)
    net = tpol.init_policy(torch.Generator().manual_seed(0), H, n_u, lb, ub, uref)
    jtree = jpol.init_policy(jax.random.PRNGKey(0), H, n_u, lb, ub, uref)
    for k, v in jtree["net"].items():
        assert tuple(getattr(net, k).shape) == v.shape, k
    np.testing.assert_array_equal(net.b2.numpy(), jtree["net"]["b2"])
    # zero features (every error 0, at rest, u_prev 0): the head is its bias
    plan = tpol.policy_apply(net, torch.zeros(3, tpol.policy_feat_dim(H, n_u)), T(lb), T(ub))
    assert plan.shape == (3, H, n_u)
    np.testing.assert_allclose(plan.numpy(), np.broadcast_to(uref, (3, H, n_u)), atol=1e-6)


def policy_cfg(repo_root, vehicle, kind, **policy):
    """A shipped config as the policy family: ``solver: policy`` on its
    shipped checkpoint (both packages' loaders)."""
    cfg = j_load_yaml(os.path.join(repo_root, f"configs/{vehicle}_{kind}_mpc.yaml"))
    cfg["solver"] = "policy"
    cfg["policy"] = dict(params_path=os.path.join(
        repo_root, f"configs/models/{vehicle}_{kind}_policy.pkl"), **policy)
    return cfg


def start_state(sft_j, kind):
    """The lemniscate at 3 s (a trajectory config), else an offset hover."""
    if kind == "traj":
        return np.array(j_enu2ned(sft_j(jnp.float32(3.0))), np.float32)
    x = hover_state().numpy()
    x[0], x[2], x[4] = 0.5, -0.3, 0.2
    return x


@pytest.mark.parametrize("vehicle, kind", CHECKPOINTS)
def test_shipped_checkpoints_pure_policy_match_jax(repo_root, vehicle, kind):
    """Three chained pure-policy solves from the same states (JAX's chain):
    plans, telemetry costs and ``x_evol`` against JAX's ``mpc_fn``; no
    kernel launches on the CPU."""
    cfg = policy_cfg(repo_root, vehicle, kind)
    _, (j_reset, j_mpc), sft_j, jb = j_make_mpc(copy.deepcopy(cfg))
    _, (t_reset, t_mpc), _, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    # the metric loads as for solver: apg (original :509)
    assert (tb.precond is not None) == (cfg["apg_mpc"].get("precond") == "hover_diag")
    x = start_state(sft_j, kind)
    t0 = 3.0 if kind == "traj" else 0.0
    rng = jax.random.PRNGKey(0)
    st_j, st_t = j_reset(jnp.asarray(x), rng, jnp.asarray(x)), t_reset(T(x), None, T(x))
    jm = jax.jit(j_mpc)
    n0 = (CO.value_batch_kernel.launches, CO.trajectory_kernel.launches)
    for k in range(3):
        t = np.float32(t0 + 0.05 * k)
        u_j, st_j, rng, xe_j = jm(jnp.asarray(x), rng, st_j, t, jnp.asarray(x))
        u_t, st_t, _, xe_t = t_mpc(T(x), None, st_t, t, T(x))
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-5, rtol=0)
        for f in ("init_cost", "opt_cost"):
            np.testing.assert_allclose(float(getattr(st_t, f)), float(getattr(st_j, f)),
                                       rtol=2e-5)
        # x_evol: JAX's mean rollout of the port's own plan
        # (tests/test_apg_kernel.py:199)
        ref = j_rollout_mean(jb.model, jb.params, jnp.asarray(x), jnp.asarray(u_t.numpy()),
                             jb.time_steps)
        np.testing.assert_allclose(xe_t.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
        assert float(st_t.num_steps) == 0.0 == float(st_j.num_steps)
        np.testing.assert_allclose(st_t.yk.numpy(), np.asarray(st_j.yk), atol=1e-5, rtol=0)
        x = np.array(xe_j[1], np.float32)
    assert (CO.value_batch_kernel.launches, CO.trajectory_kernel.launches) == n0


def test_family_policy_replays_golden(repo_root, tmp_path):
    """The untrained init the JAX package draws from the config's seed
    (``PRNGKey(0)``, hidden (256, 256)), carried across in a checkpoint,
    replays the committed trace."""
    cfg = j_load_yaml(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    from sde4mbrl_px4_tpu.io.config import input_bounds_from_config

    lb, ub = input_bounds_from_config(cfg)
    uref = np.broadcast_to(np.asarray(cfg["cost_params"]["uref"], np.float32), (4,))
    tree = jpol.init_policy(jax.random.PRNGKey(int(cfg.get("seed", 0))), 20, 4, lb, ub, uref)
    path = write_checkpoint(tmp_path / "init_policy.pkl", tree)
    tr = G.replay_solver_family(repo_root, "policy", device="cpu", policy_path=path)
    ref = np.load(os.path.join(G.golden_dir(repo_root), "family_policy_trace.npz"))["trace"]
    assert tr.shape == ref.shape and (tr[:, -1] == 0).all()
    np.testing.assert_allclose(tr, ref, atol=1e-4, rtol=1e-4)


def test_hybrid_first_solve_lockstep_with_jax(repo_root):
    """``refine_iters`` 3 on the iris traj checkpoint: the cold solve is the
    network's plan polished by 3 linesearch iterations, as JAX's XLA solve
    (the original's warm start and stepsize carry), and a warm solve keeps
    the shifted plan (the select), with its own 3 iterations."""
    cfg = policy_cfg(repo_root, "iris", "traj", refine_iters=3)
    _, (j_reset, j_mpc), sft_j, _ = j_make_mpc(copy.deepcopy(cfg), use_pallas=False)
    _, (t_reset, t_mpc), _, tb = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    assert tb.apg_config.max_iter == 3 == tb.apg_config.max_no_improvement_iter
    x = start_state(sft_j, "traj")
    x[0] += 0.2
    rng = jax.random.PRNGKey(0)
    st_j, st_t = j_reset(jnp.asarray(x), rng, jnp.asarray(x)), t_reset(T(x), None, T(x))
    launches = AK.apg_solve_kernel.launches
    u_j, st_j, rng, _ = jax.jit(j_mpc)(jnp.asarray(x), rng, st_j, jnp.float32(3.0),
                                       jnp.asarray(x))
    u_t, st_t1, _, xe = t_mpc(T(x), None, st_t, np.float32(3.0), T(x))
    assert AK.apg_solve_kernel.launches == launches
    assert float(st_t1.num_steps) == float(st_j.num_steps) == 3.0
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(st_t1.opt_cost), float(st_j.opt_cost), rtol=2e-4)
    # the select: cold (num_steps 0) takes the plan, warm keeps the warm start
    pieces_plan = torch.full((20, 4), 0.3)
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import build_mpc

    pieces = build_mpc(copy.deepcopy(cfg), device="cpu")[2]
    assert torch.equal(pieces.cold_start(st_t, pieces_plan), pieces_plan)
    assert torch.equal(pieces.cold_start(st_t1, pieces_plan), st_t1.yk)
    _, st_t2, _, _ = t_mpc(T(x), None, st_t1, np.float32(3.05), T(x))
    assert float(st_t2.num_steps) == 3.0 and torch.isfinite(st_t2.yk).all()


def test_hybrid_honors_iter_budget(repo_root):
    """The hybrid's polish is an APG loop: ``iter_budget`` caps it at
    min(refine_iters, budget); the pure policy ignores the budget."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
    cfg["solver"] = "policy"
    cfg["policy"] = {"refine_iters": 10}
    _, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    assert b.precond is not None              # the committed hover_diag artifact
    x = enu2ned(sft(np.float32(3.0)))
    st = reset_fn(x, None, x)
    capped = mpc_fn(x, None, st, np.float32(3.0), x, 3)
    assert float(capped.opt_state.num_steps) == 3.0
    uncapped = mpc_fn(x, None, st, np.float32(3.0), x, 100)
    assert float(uncapped.opt_state.num_steps) == 10.0
    cfg["policy"] = {}
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg, device="cpu")
    pure = mpc_fn(x, None, reset_fn(x, None, x), np.float32(3.0), x, 3)
    assert float(pure.opt_state.num_steps) == 0.0


def _bad_checkpoint(repo_root, tmp_path, what):
    """A config whose policy block the loader must refuse."""
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["solver"] = "policy"
    ckpt = os.path.join(repo_root, "configs/models/iris_posctrl_policy.pkl")
    if what == "missing":
        cfg["policy"] = {"params_path": str(tmp_path / "nope.pkl")}
    elif what == "kind":
        with open(ckpt, "rb") as f:
            blob = pickle.load(f)
        path = tmp_path / "sde.pkl"
        with open(path, "wb") as f:
            pickle.dump({"params": blob["params"], "meta": {"kind": "sde_v2"}}, f)
        cfg["policy"] = {"params_path": str(path)}
    elif what == "horizon":
        cfg.update(horizon=10, num_short_dt=10)
        cfg["policy"] = {"params_path": ckpt}
    elif what == "refine":
        cfg["policy"] = {"refine_iters": -1}
    else:
        cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_constr_posctrl_mpc.yaml"))
        cfg["solver"] = "policy"
    return cfg


@pytest.mark.parametrize("what, match", [
    ("missing", "does not exist"), ("kind", "not an MPC policy checkpoint"),
    ("horizon", "horizon/motors"), ("refine", "refine_iters must be >= 0"),
    ("proximal", "slack_proximal")])
def test_policy_loader_refusals(repo_root, tmp_path, what, match):
    """The original's refusals: a configured checkpoint that is missing, of
    another kind or of another H/n_u; negative ``refine_iters``; proximal
    slack. The JAX loader refuses the same configs."""
    cfg = _bad_checkpoint(repo_root, tmp_path, what)
    with pytest.raises(ValueError, match=match):
        make_mpc_from_config(copy.deepcopy(cfg), device="cpu")
    with pytest.raises(ValueError, match=match):
        j_make_mpc(copy.deepcopy(cfg))
