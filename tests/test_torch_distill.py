"""Port parity, policy distillation (``learning/distill.py``) against the
JAX package's, on the CPU, from the same inputs: the posctrl config cut to
H = 6 and ``max_iter`` 15 (``tests/test_distill.py``'s).

- ``sample_states``: the map from draws to states, given the JAX
  package's draws (its key splits rebuilt here), atol 1e-6;
- ``build_features`` at atol 1e-6 (``tests/test_torch_policy.py``'s);
- ``label_states`` on the CPU's plain batched route, given JAX's states and
  previous commands: JAX's labels at the fixed-budget tolerance (rtol
  2e-4, atol 2e-5, ``tests/test_apg_kernel.py:60-69``); over a pair of
  CPU ranks (``mesh=``), the one-process labels row for row;
- ``train_policy``, 20 AdamW steps in lockstep given JAX's minibatch
  indices and initial network: rtol 1e-4 with an atol of lr / 1000 (a
  thousandth of one Adam step; ``tests/test_torch_learning.py`` says why);
- the warmup-cosine schedule against ``optax.warmup_cosine_decay_schedule``
  at every step, to 1e-7;
- ``_dagger_states`` given JAX's draws and policy: JAX's harvest, atol 1e-5;
- ``save_policy`` / ``load_policy`` both ways, and the port's checkpoint
  served by ``solver: policy`` in both packages;
The traj twin's parity checks: ``tests/test_torch_distill_traj.py``; the
twin of ``tests/test_distill.py::test_distillation_learns_expert`` and
``distill_policy``: ``tests/test_torch_distill_learns.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as j_make
from sde4mbrl_px4_tpu.io.config import load_yaml_config as j_load
from sde4mbrl_px4_tpu.learning import distill as JD
from sde4mbrl_px4_tpu.models import policy as jpol
from sde4mbrl_px4_tpu_torch.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config
from sde4mbrl_px4_tpu_torch.learning import distill as TD
from sde4mbrl_px4_tpu_torch.models.policy import PolicyNet, policy_from_numpy

T = torch.from_numpy
LABEL_RTOL, LABEL_ATOL = 2e-4, 2e-5
N_LABELS = 8


def _cfg(repo_root, kind, load):
    cfg = load(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg.update(horizon=6, num_short_dt=6)
    cfg["apg_mpc"].update(max_iter=15, max_no_improvement_iter=15)
    if kind == "traj":
        cfg["trajectory_path"] = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
        cfg["apg_mpc"]["precond"] = "hover_diag"
    return cfg


def make_pair(repo_root, kind):
    """(kind, JAX cfg, JAX bundle, port cfg, port bundle)."""
    jc, tc = _cfg(repo_root, kind, j_load), _cfg(repo_root, kind, load_yaml_config)
    _, _, _, jb = j_make(dict(jc))
    _, _, _, tb = make_mpc_from_config(dict(tc), device="cpu")
    return kind, jc, jb, tc, tb


@pytest.fixture(scope="module")
def pair(repo_root):
    return make_pair(repo_root, "posctrl")


def _jax_state_draws(jb, n, rng, dcfg):
    """The draws JAX's ``sample_states`` makes from ``rng`` (its ``:123-165``)."""
    ks = jax.random.split(rng, 8)
    nrm = lambda k, s: np.asarray(jax.random.normal(k, s, jnp.float32))
    traj = jb.state_from_traj is not None
    t = target = start = tyaw = None
    if traj:
        T_tab = float(getattr(jb.state_from_traj, "t_max", 10.0))
        t = np.asarray(jax.random.uniform(ks[0], (n,), minval=0.0, maxval=T_tab))
    else:
        k_t, k_s, k_y = jax.random.split(ks[5], 3)
        target, start = nrm(k_t, (n, 3)), nrm(k_s, (n, 3))
        tyaw = np.asarray(jax.random.uniform(k_y, (n,), minval=-np.pi, maxval=np.pi))
    return TD.StateDraws(t, target, start, tyaw, nrm(ks[1], (n, 3)), nrm(ks[2], (n, 3)),
                         nrm(ks[3], (n, 2)), nrm(ks[6], (n, 1)), nrm(ks[4], (n, 3)),
                         nrm(ks[7], (n, 4)))


@pytest.fixture(scope="module")
def states(pair):
    """JAX's sampled states and the port's from the same draws."""
    kind, jc, jb, tc, tb = pair
    dcfg = TD.DistillConfig(expert_max_iter=15)
    rng = jax.random.PRNGKey(1)
    j_states = [np.asarray(a) for a in JD.sample_states(jb, N_LABELS, rng, JD.DistillConfig())]
    t_states = TD.sample_states(tb, N_LABELS, _jax_state_draws(jb, N_LABELS, rng, dcfg), dcfg)
    return j_states, t_states, dcfg


def test_sample_states_map_matches_jax(pair, states):
    j_states, t_states, _ = states
    for name, a, b in zip(("xs", "ts", "xdes", "u_prevs"), t_states, j_states):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, err_msg=name)
    # the port's own draws: the same shapes, every state inside its envelope
    xs, ts, xdes, ups = TD.sample_states(pair[4], 16, torch.Generator().manual_seed(0))
    assert xs.shape == (16, 13) and ups.shape == (16, 4) and torch.isfinite(xs).all()
    assert torch.allclose(torch.linalg.norm(xs[:, 6:10], dim=1), torch.ones(16), atol=1e-6)
    assert (ups >= pair[4].lb).all() and (ups <= pair[4].ub).all()


def test_build_features_match_jax(pair, states):
    _, _, jb, _, tb = pair
    j_states, _, _ = states
    a = TD.build_features(tb, *map(T, j_states))
    b = np.asarray(JD.build_features(jb, *map(jnp.asarray, j_states)))
    np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    np.testing.assert_allclose(TD.build_features(tb, *map(T, j_states[:3])).numpy(),
                               np.asarray(JD.build_features(jb, *map(jnp.asarray,
                                                                     j_states[:3]))), atol=1e-6)


def test_label_states_match_jax(pair, states):
    """JAX's vmapped XLA solves against the port's batched plain route (one
    solo plain solve per scenario on the CPU), the same 15-iteration budget."""
    kind, jc, jb, tc, tb = pair
    j_states, _, dcfg = states
    xs, ts, xdes, ups = j_states
    jd = JD.DistillConfig(expert_max_iter=15)
    lab_j = np.asarray(JD.label_states(jc, *map(jnp.asarray, (xs, ts, xdes)),
                                       jax.random.PRNGKey(2), jd, u_prevs=jnp.asarray(ups)))
    lab_t = TD.label_states(tc, *map(T, (xs, ts, xdes)), None, dcfg, u_prevs=T(ups),
                            device="cpu")
    assert lab_t.shape == (N_LABELS, 6, 4)
    np.testing.assert_allclose(lab_t.numpy(), lab_j, rtol=LABEL_RTOL, atol=LABEL_ATOL)


def test_label_states_mesh_is_refused(pair, states):
    """``mesh=`` runs: the first 5 states labelled over a pair of CPU ranks
    (a (2, 1) mesh, ``parallel/rank_tasks.py::labels``; padded to 6, 3
    rows a rank, gathered and cut back) equal the one-process labels row
    for row, bit for bit."""
    from sde4mbrl_px4_tpu_torch.parallel.distributed import spawn_ranks

    xs, ts, xdes, ups = (a[:5] for a in states[1])
    ranks = spawn_ranks("sde4mbrl_px4_tpu_torch.parallel.rank_tasks:labels", 2,
                        dict(cfg=pair[3], xs=xs, ts=ts, xdes=xdes, u_prevs=ups,
                             expert_max_iter=states[2].expert_max_iter, devices="cpu"),
                        timeout=90.0)
    one = TD.label_states(pair[3], xs, ts, xdes, None, states[2], u_prevs=ups, device="cpu")
    assert one.shape == (5, 6, 4)
    for r in ranks:
        np.testing.assert_array_equal(r["labels"], one.numpy())


@pytest.mark.parametrize("steps", [11, 200, 3000])
def test_schedule_matches_optax(steps):
    lr = 1e-3
    ref = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=max(10, steps // 50),
        decay_steps=steps, end_value=lr * 0.01)
    sched = TD.warmup_cosine(lr, steps)
    counts = np.arange(steps + 5)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(counts)))
    got = np.array([sched(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # the optimizer reads it: LambdaLR on lr 1 gives sched(count) before each update
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.AdamW([p], lr=1.0)
    ls = torch.optim.lr_scheduler.LambdaLR(opt, sched)
    for c in range(12):
        assert opt.param_groups[0]["lr"] == sched(c)
        opt.step()
        ls.step()
    with pytest.raises(ValueError, match="decay_steps"):
        TD.warmup_cosine(lr, 10)


def _jax_indices(seed, steps, bs, n):
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (bs,), 0, n)))
    return out


def test_train_policy_lockstep_with_jax():
    """20 steps (10 of warmup, 10 of cosine) from JAX's init, on JAX's
    indices: the weights at rtol 1e-4 / atol lr/1000, the logged losses."""
    rs = np.random.RandomState(0)
    n, H, n_u = 40, 6, 4
    feats = rs.randn(n, 9 * (H + 1) + 6 + n_u).astype(np.float32)
    labels = rs.uniform(0.2, 0.9, (n, H, n_u)).astype(np.float32)
    lb, ub, uref = np.full(4, 1e-4, np.float32), np.ones(4, np.float32), np.full(4, 0.6, np.float32)
    dcfg = JD.DistillConfig(hidden=(32, 32), batch_size=16, steps=20, lr=3e-3, weight_decay=1e-3,
                            seed=4)
    init = jax.tree.map(np.asarray, jpol.init_policy(jax.random.PRNGKey(dcfg.seed), H, n_u, lb,
                                                     ub, uref, hidden=dcfg.hidden))
    pj, sj = JD.train_policy(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(lb),
                             jnp.asarray(ub), jnp.asarray(uref), dcfg)
    tcfg = TD.DistillConfig(**{f: getattr(dcfg, f) for f in dcfg.__dataclass_fields__})
    pt, st = TD.train_policy(T(feats), T(labels), lb, ub, uref, tcfg,
                             params=policy_from_numpy(init),
                             indices=iter(_jax_indices(dcfg.seed, 20, 16, n)))
    assert isinstance(pt, PolicyNet) and (pt.H, pt.n_u) == (6, 4)
    for k, v in pj["net"].items():
        np.testing.assert_allclose(getattr(pt, k).numpy(), np.asarray(v), rtol=1e-4,
                                   atol=dcfg.lr / 1000, err_msg=k)
        assert not np.allclose(np.asarray(v), init["net"][k]) or k.startswith("b")
    np.testing.assert_allclose(st["losses"], sj["losses"], rtol=1e-4)
    assert st["n"] == n and st["H"] == H and len(st["losses"]) == 2


def test_dagger_states_match_jax(pair):
    """The policy flown on the mean dynamics from JAX's draws: JAX's harvest."""
    kind, jc, jb, tc, tb = pair
    dcfg = JD.DistillConfig(dagger_rollouts=4, dagger_steps=5)
    lb, ub = np.asarray(jb.lb), np.asarray(jb.ub)
    p = jax.tree.map(np.asarray, jpol.init_policy(jax.random.PRNGKey(0), 6, 4, lb, ub,
                                                  np.asarray(jb.cost_params.uref),
                                                  hidden=(32,)))
    p["net"]["w1"] = p["net"]["w1"] * 300.0            # a policy that does not hover
    rng = jax.random.PRNGKey(7)
    want = [np.asarray(a) for a in JD._dagger_states(jc, jb, jax.tree.map(jnp.asarray, p),
                                                      dcfg, rng)]
    k0, k1 = jax.random.split(rng)
    if kind == "traj":
        T_tab = float(getattr(jb.state_from_traj, "t_max", 10.0))
        hi = max(T_tab - 5 * float(jb.time_steps[0]), 1e-3)
        draws = TD.DaggerDraws(np.asarray(jax.random.uniform(k0, (4,), minval=0.0, maxval=hi)),
                               None, None, None)
    else:
        ka, kb, kc = jax.random.split(k1, 3)
        draws = TD.DaggerDraws(None, np.asarray(jax.random.normal(ka, (4, 3))),
                               np.asarray(jax.random.normal(kb, (4, 3))),
                               np.asarray(jax.random.uniform(kc, (4,), minval=-np.pi,
                                                             maxval=np.pi)))
    got = TD._dagger_states(tc, tb, policy_from_numpy(p), dcfg, draws)
    for name, a, b in zip(("xs", "ts", "xdes", "u_prevs"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=name)
    assert np.std(want[3]) > 1e-3                       # the commands moved


def test_policy_checkpoints_load_both_ways(repo_root, tmp_path):
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config as jmake

    lb, ub, uref = np.full(4, 1e-4), np.ones(4), np.full(4, 0.71, np.float32)
    jp = jpol.init_policy(jax.random.PRNGKey(0), 6, 4, lb, ub, uref, hidden=(32,))
    pj = str(tmp_path / "jax.pkl")
    JD.save_policy(pj, jp, {"note": "jax"})
    net, meta = TD.load_policy(pj, device="cpu")
    assert meta == {"kind": "mpc_policy_v1", "note": "jax"} and (net.H, net.n_u) == (6, 4)
    np.testing.assert_array_equal(net.w0.numpy(), jp["net"]["w0"])
    pt = str(tmp_path / "port.pkl")
    TD.save_policy(pt, net, {"note": "port"})
    back, meta2 = JD.load_policy(pt)
    assert meta2["note"] == "port" and back["meta_H"].dtype == jnp.int32
    for k in jp["net"]:
        np.testing.assert_array_equal(np.asarray(back["net"][k]), jp["net"][k])
    assert int(back["meta_H"]) == 6 and int(back["meta_n_u"]) == 4
    with pytest.raises(ValueError, match="mpc_policy_v1"):
        from sde4mbrl_px4_tpu_torch.models.params_io import save_params

        save_params(str(tmp_path / "sde.pkl"), {"net": {}}, {"kind": "sde"})
        TD.load_policy(str(tmp_path / "sde.pkl"), device="cpu")
    # the port's checkpoint serves through solver: policy in both packages
    x = np.zeros(13, np.float32)
    x[6], x[0] = 1.0, 0.4
    plans = []
    for make, load, dev in ((make_mpc_from_config, load_yaml_config, {"device": "cpu"}),
                            (jmake, j_load, {})):
        cfg = _cfg(repo_root, "posctrl", load)
        cfg.update(solver="policy", policy={"params_path": pt})
        _, (reset_fn, mpc_fn), _, _ = make(cfg, **dev)
        xx = torch.from_numpy(x) if dev else jnp.asarray(x)
        sol = mpc_fn(xx, None if dev else jax.random.PRNGKey(0),
                     reset_fn(xx, None, xx), 0.0, xx)
        plans.append(np.asarray(sol.u_opt))
    np.testing.assert_allclose(plans[0], plans[1], atol=1e-5)
