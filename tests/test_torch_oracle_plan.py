"""The launch plan of the cost oracle's ``value_batch`` kernel, on the CPU.

``consts.value_batch_grid`` mirrors ``csrc/cost_oracle.cu::value_batch_launch``
(``chip_smoke.py`` phase 4 holds the mirror to the library's own
``value_batch_rows`` on the card):

- with particles, a grid of K clusters of C blocks, block b sweeping the
  chunks rank, rank + C, ... (rank = b % C) of candidate b // C, so every
  (candidate, chunk) pair has exactly one block, every block at least one
  chunk and none more than ``chunks_per_block``;
- at P=1, ceil(K / rows) blocks of ``rows`` candidates: at most
  ``ORACLE_P1_ROWS`` (one warp each, the register chain) on a trunk of the
  register layout, ``ORACLE_TILE`` on others, at most K, fewer where a
  block's shared memory would not fit; every candidate in one block;
- ``cost_oracle.plan_oracle_particles`` gives both particle kernels one
  chunk and one cluster, capped by the smaller of their largest clusters.
"""
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (APG_MAXK, ORACLE_P1_ROWS, ORACLE_TILE,
                                                    ORACLE_VALUE_AND_GRAD, ORACLE_VALUE_BATCH,
                                                    ApgArgs, plan_cluster, value_batch_grid)


def p1_args(F=13, HID=64):
    a = ApgArgs()
    a.F, a.HID, a.OUT = F, HID, 12
    return a


def particle_args(n_chunks, c_max):
    a = ApgArgs()
    a.has_noise, a.n_chunks = 1, n_chunks
    a.cluster, a.chunks_per_block = plan_cluster(n_chunks, c_max)
    return a


@settings(max_examples=300, deadline=None)
@given(K=st.integers(1, 300), n_chunks=st.integers(1, 64), c_max=st.sampled_from([1, 8, 16]))
def test_particle_grid_covers_every_candidate_chunk_once(K, n_chunks, c_max):
    a = particle_args(n_chunks, c_max)
    C = a.cluster
    blocks, rows = value_batch_grid(K, a)
    assert (blocks, rows) == (K * C, 1)
    owner = {}
    for b in range(blocks):
        cand, rank = divmod(b, C)
        mine = range(rank, n_chunks, C)
        assert 1 <= len(mine) <= a.chunks_per_block
        for ch in mine:
            assert (cand, ch) not in owner
            owner[(cand, ch)] = b
    assert len(owner) == K * n_chunks
    assert {k for k, _ in owner} == set(range(K))


@settings(max_examples=300, deadline=None)
@given(K=st.integers(1, 600), HID=st.sampled_from([32, 48, 64, 128]),
       F=st.sampled_from([13, 15, 16, 20]), most=st.integers(1, 16))
def test_p1_grid_covers_every_candidate_once(K, HID, F, most):
    """``most``: the rows whose shared memory still fits."""
    a = p1_args(F, HID)
    blocks, rows = value_batch_grid(K, a, fits=lambda r: r <= most)
    reg = HID == 64 and F <= 16
    assert 1 <= rows <= min(K, ORACLE_P1_ROWS if reg else ORACLE_TILE)
    assert rows == max(1, min(K, ORACLE_P1_ROWS if reg else ORACLE_TILE, most))
    assert rows <= APG_MAXK or not reg            # one warp of 256 threads per row
    seen = [k for b in range(blocks) for k in range(b * rows, min(K, (b + 1) * rows))]
    assert seen == list(range(K))
    assert (blocks - 1) * rows < K                # no block without a candidate


@pytest.mark.parametrize("K, F, HID, want", [
    (1, 13, 64, (1, 1)), (4, 13, 64, (1, 4)), (8, 13, 64, (1, 8)), (9, 13, 64, (2, 8)),
    (17, 13, 64, (3, 8)), (64, 13, 64, (8, 8)), (256, 13, 64, (32, 8)),
    (64, 15, 64, (8, 8)), (64, 13, 48, (4, 16)), (17, 13, 48, (2, 16)), (64, 17, 64, (4, 16))])
def test_p1_grid_examples(K, F, HID, want):
    """The grids the routes launch: MPPI's K=64 in 8 blocks of 8 on the iris
    (F = 13) and hexa (F = 15) trunks; 16 rows a block off the register
    layout (a 48-unit trunk, or F > 16)."""
    assert value_batch_grid(K, p1_args(F, HID)) == want


class FakeOracleLibrary:
    """The entry points ``plan_oracle_particles`` reads, with shared memory
    growing with the chunk."""

    def __init__(self, vb_max, vg_max):
        self.c_max = {ORACLE_VALUE_BATCH: vb_max, ORACLE_VALUE_AND_GRAD: vg_max}

    def oracle_cluster_max(self, kind, sc_kind, opt, bf16):
        return self.c_max[kind]

    def value_batch_smem_bytes(self, a, K):
        return 1000 * a._obj.Pc + 8 * a._obj.chunks_per_block

    def value_and_grad_smem_bytes(self, a):
        return 4000 * a._obj.Pc + 400 * a._obj.chunks_per_block


@pytest.mark.parametrize("vb_max, vg_max, cluster, want", [
    (16, 16, 0, (32, 16, 16, 1)), (8, 16, 0, (32, 16, 8, 2)), (16, 8, 0, (32, 16, 8, 2)),
    (16, 16, 1, (32, 16, 1, 16)), (16, 16, 4, (32, 16, 4, 4))])
def test_oracle_plan_is_one_chunk_and_cluster_for_both(vb_max, vg_max, cluster, want):
    """One chunk for both kernels (the mean of chunk means depends on it),
    the largest divisor of P whose blocks both fit; one cluster, C =
    min(n_chunks, C_max), C_max the smaller largest cluster of the two or
    ``cluster`` (1 to C_max)."""
    a = ApgArgs()
    CO.plan_oracle_particles(FakeOracleLibrary(vb_max, vg_max), a, 512, 0, cluster)
    assert (a.Pc, a.n_chunks, a.cluster, a.chunks_per_block) == want


@pytest.mark.parametrize("cluster", [9, 17, -1])
def test_oracle_plan_refuses_a_cluster_past_the_largest(cluster):
    with pytest.raises(ValueError, match="the oracle kernels take 1 to 8 blocks"):
        CO.plan_oracle_particles(FakeOracleLibrary(8, 16), ApgArgs(), 512, 0, cluster)

