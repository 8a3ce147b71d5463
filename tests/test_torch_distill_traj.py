"""Port parity, policy distillation on the traj config: the checks of
``tests/test_torch_distill.py`` that take a config (``sample_states``,
``build_features``, ``label_states``, ``_dagger_states``) on its traj
twin: the lemniscate at H = 6, ``max_iter`` 15, per-scenario ``curr_t``,
and the ``hover_diag`` metric, which both packages probe into a
temporary cache (no committed file has this key).
"""
import os

import pytest

from test_torch_distill import (  # noqa: F401  (collected here on the traj pair)
    make_pair, states, test_build_features_match_jax, test_dagger_states_match_jax,
    test_label_states_match_jax, test_sample_states_map_matches_jax)


@pytest.fixture(scope="module")
def pair(repo_root, tmp_path_factory):
    old = os.environ.get("SDE4MBRL_PRECOND_CACHE")
    os.environ["SDE4MBRL_PRECOND_CACHE"] = str(tmp_path_factory.mktemp("precond"))
    try:
        yield make_pair(repo_root, "traj")
    finally:
        if old is None:
            del os.environ["SDE4MBRL_PRECOND_CACHE"]
        else:
            os.environ["SDE4MBRL_PRECOND_CACHE"] = old
