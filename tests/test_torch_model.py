"""Port parity, model layer: parameters carried across from the JAX
package, the SDE trunk and drift, the rollouts and the trajectory sampler,
against ``sde4mbrl_px4_tpu`` on the same seeded inputs at rtol 1e-5.

Weights: the committed checkpoint ``configs/models/iris_sde.pkl`` and a
fresh JAX ``init_params`` tree, both through ``params_from_numpy``. The
Brownian block of ``rollout_sde`` is drawn on the JAX side
(``draw_brownian``, what the JAX rollout draws internally) and injected
into the port."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde4mbrl_px4_tpu.models import sde_model as jm
from sde4mbrl_px4_tpu.models import trajectory as jtraj
from sde4mbrl_px4_tpu.models.params_io import load_params as j_load_params
from sde4mbrl_px4_tpu.models.vehicles import iris_config as j_iris
from sde4mbrl_px4_tpu.ops import rollout as jr
from sde4mbrl_px4_tpu_torch.models import sde_model as tm
from sde4mbrl_px4_tpu_torch.models import trajectory as ttraj
from sde4mbrl_px4_tpu_torch.models.params_io import load_params, params_from_numpy
from sde4mbrl_px4_tpu_torch.models.vehicles import iris_config
from sde4mbrl_px4_tpu_torch.ops import rollout as tr

RTOL, ATOL = 1e-5, 1e-6
H = 20


@pytest.fixture(scope="module", params=["checkpoint", "fresh"])
def models(request, repo_root):
    jmodel = jm.NeuralSDE(vehicle=j_iris())
    if request.param == "checkpoint":
        tree, _ = j_load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    else:
        tree = jm.init_params(jax.random.PRNGKey(3), jmodel)
    jparams = jax.tree.map(jnp.asarray, tree)
    tmodel = tm.NeuralSDE.for_vehicle(iris_config())
    return jmodel, jparams, tmodel, params_from_numpy(tree)


def _states(n, seed=0):
    rs = np.random.RandomState(seed)
    x = (0.5 * rs.randn(n, 13)).astype(np.float32)
    q = rs.randn(n, 4).astype(np.float32)
    x[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    u = rs.uniform(0.3, 0.95, (n, 4)).astype(np.float32)
    return x, u


def _close(t_out, j_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=rtol, atol=atol)


def test_params_from_numpy_round_trip(repo_root):
    tree, meta = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    jtree, jmeta = j_load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    assert meta == jmeta
    p = params_from_numpy(tree)
    for k in ("w0", "b0", "w1", "b1", "w2", "b2"):
        assert p["net"][k].dtype == torch.float32
        np.testing.assert_array_equal(p["net"][k].numpy(), np.asarray(jtree["net"][k]))
    np.testing.assert_array_equal(p["motor"]["log_gain"].numpy(),
                                  np.asarray(jtree["motor"]["log_gain"]))
    assert float(p["diffusion_log_scale"]) == float(np.float32(jtree["diffusion_log_scale"]))


def test_trunk_apply(models):
    jmodel, jparams, tmodel, tparams = models
    x, u = _states(128)
    res_t, sig_t = tm.trunk_apply(tparams, torch.from_numpy(x), torch.from_numpy(u))
    res_j, sig_j = jm.trunk_apply(jparams, jnp.asarray(x), jnp.asarray(u))
    _close(res_t, res_j)
    _close(sig_t, sig_j)


@pytest.mark.parametrize("fn", ["drift_and_sigma", "drift_fn", "diffusion_fn"])
def test_drift_and_sigma(models, fn):
    jmodel, jparams, tmodel, tparams = models
    x, u = _states(128, seed=1)
    out_t = getattr(tm, fn)(tmodel, tparams, torch.from_numpy(x), torch.from_numpy(u))
    out_j = getattr(jm, fn)(jmodel, jparams, jnp.asarray(x), jnp.asarray(u))
    if fn == "drift_and_sigma":
        _close(out_t[0], out_j[0])
        _close(out_t[1], out_j[1])
    else:
        _close(out_t, out_j)


def _plan(seed):
    rs = np.random.RandomState(seed)
    x0, _ = _states(1, seed)
    return x0[0], rs.uniform(0.55, 0.85, (H, 4)).astype(np.float32)


def test_rollout_mean(models):
    jmodel, jparams, tmodel, tparams = models
    x0, u = _plan(2)
    ts = jr.make_time_steps(H, 10, 0.05, 0.1)
    out_t = tr.rollout_mean(tmodel, tparams, torch.from_numpy(x0), torch.from_numpy(u),
                            torch.from_numpy(ts))
    out_j = jr.rollout_mean(jmodel, jparams, jnp.asarray(x0), jnp.asarray(u),
                            jnp.asarray(ts))
    _close(out_t, out_j)


@pytest.mark.parametrize("P,deterministic", [(1, True), (8, False)])
def test_rollout_sde_with_injected_noise(models, P, deterministic):
    jmodel, jparams, tmodel, tparams = models
    x0, u = _plan(4)
    ts = jr.make_time_steps(H, 20, 0.05, 0.05)
    rng = jax.random.PRNGKey(5)
    xp_j, sg_j = jr.rollout_sde(jmodel, jparams, jnp.asarray(x0), jnp.asarray(u),
                                jnp.asarray(ts), rng, P, deterministic=deterministic)
    noise = (np.zeros((H, P, 13), np.float32) if deterministic
             else np.array(jr.draw_brownian(rng, H, P)))
    xp_t, sg_t = tr.rollout_sde(tmodel, tparams, torch.from_numpy(x0),
                                torch.from_numpy(u), torch.from_numpy(ts),
                                torch.from_numpy(noise))
    assert xp_t.shape == (P, H + 1, 13) and sg_t.shape == (P, H, 13)
    _close(xp_t, xp_j)
    _close(sg_t, sg_j)


def test_make_time_steps_copied():
    for args in ((20, 20, 0.05, 0.05), (20, 8, 0.05, 0.1), (5, 9, 0.02, 0.1)):
        np.testing.assert_array_equal(tr.make_time_steps(*args), jr.make_time_steps(*args))


@pytest.mark.parametrize("convert_to_ned", [False, True])
def test_trajectory_table_and_sampler(repo_root, convert_to_ned):
    path = os.path.join(repo_root, "configs/trajs/lemniscate.csv")
    t_tab = ttraj.load_trajectory_csv(path, convert_to_ned=convert_to_ned)
    j_tab = jtraj.load_trajectory_csv(path, convert_to_ned=convert_to_ned)
    np.testing.assert_array_equal(t_tab.times, np.asarray(j_tab.times))
    np.testing.assert_allclose(t_tab.states, np.asarray(j_tab.states),
                               rtol=RTOL, atol=ATOL)
    # lerp + normalize + clamp past both ends, scalar and batched times
    t_s = ttraj.make_state_from_traj(t_tab)
    j_s = jtraj.make_state_from_traj(j_tab)
    times = np.concatenate([[-1.0, 0.0, 0.013, 3.0, 7.77],
                            np.random.RandomState(6).uniform(0, t_tab.duration, 40),
                            [t_tab.duration, t_tab.duration + 5.0, 1e9]]).astype(np.float32)
    _close(t_s(torch.from_numpy(times)), j_s(jnp.asarray(times)))
    _close(t_s(3.21), j_s(jnp.float32(3.21)))
