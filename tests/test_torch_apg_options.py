"""Port parity, solver options: the flagship traj solve as it flies
(``hover_diag`` preconditioner + Barzilai-Borwein), the carried stepsize,
the deadline iteration budget, the ``increase`` and ``conservative`` trial
rules and ``momentum_restart: false``, each against the JAX package's XLA
``apg_solve`` in lockstep (equal ``num_steps``; rtol 2e-4, atol 2e-5, the
reference's ``tests/test_apg_kernel.py:60-69``)."""
import pytest

from _torch_parity import assert_lockstep, load_port_bundles, solve_pair

CASES = {
    "precond_bb": dict(max_iter=8, precond="hover_diag"),
    "stepsize_carry": dict(max_iter=10, t_init=0.31),
    "iter_budget": dict(max_iter=10, iter_budget=4),
    "increase": dict(max_iter=8, reset_option="increase"),
    "conservative": dict(max_iter=8, reset_option="conservative", t_init=0.05),
    "no_momentum_restart": dict(max_iter=10, momentum_restart=False),
}


@pytest.fixture(scope="module")
def port_bundles(repo_root):
    return load_port_bundles(repo_root)


@pytest.mark.parametrize("case", sorted(CASES))
def test_option_lockstep(iris_traj_bundle, port_bundles, case):
    kw = dict(CASES[case])
    tb = port_bundles["iris_traj_mpc"]
    if kw.get("precond") == "hover_diag":
        kw["precond"] = tb.precond.numpy()
    st_x, st_t, _, _ = solve_pair(iris_traj_bundle, tb, **kw)
    assert_lockstep(st_x, st_t, rtol=2e-4, atol=2e-5)
    if case == "iter_budget":
        assert int(st_t.num_steps) == 4
