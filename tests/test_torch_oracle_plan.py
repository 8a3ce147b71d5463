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
  chunk and one cluster, capped by the smaller of their largest clusters;
- ``consts.plan_groups``, the spread of the global-weight forms of the
  whole solve and of ``value_and_grad`` (``ApgArgs.groups``): 1 for every
  other plan; for those, groups * cluster blocks a scenario, never more than
  its chunks nor, over the launch's scenarios, than the card holds at once,
  and the most that fit both; ``consts.scenario_chunks`` (the kernels'
  assignment, block j chunks j, j + N, ...) covers every chunk once
  (``ApgArgs``' new ``groups`` field against the C struct:
  ``tests/test_torch_particles.py::test_apg_args_mirror_the_header``);
- a plain emulation of the spread's slot sum (each block's chunk partials
  written to their slots, every slot summed in chunk order) gives the bits
  of the one-block serial chunk loop in fp32.

``test_spread_is_bit_equal_to_one_cluster_on_cuda`` holds the planned
spread to one cluster a scenario bit for bit on the card, and skips without
one.
"""
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sde4mbrl_px4_tpu_torch.ops.cuda import cost_oracle as CO
from sde4mbrl_px4_tpu_torch.ops.cuda.consts import (APG_MAXK, ORACLE_P1_ROWS, ORACLE_TILE,
                                                    ORACLE_VALUE_AND_GRAD, ORACLE_VALUE_BATCH,
                                                    P1_BY_SHAPE, P1_CHAIN, P1_GLOBAL, P1_SMEM,
                                                    ApgArgs, plan_cluster, plan_groups,
                                                    scenario_chunks, value_batch_grid)


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



def spread_args(n_chunks, c_max, batch=1, noise=1):
    a = particle_args(n_chunks, c_max)
    a.has_noise, a.batch, a.groups = noise, batch, 1
    return a


@pytest.mark.parametrize("form", [P1_BY_SHAPE, P1_CHAIN, P1_SMEM])
@pytest.mark.parametrize("noise", [0, 1])
def test_groups_are_one_off_the_global_weight_particle_forms(form, noise):
    """Every shared-memory plan, every P=1 plan (the global-weight P=1 step
    too) and every plan named by shape keeps one cluster a scenario, however
    many chunks and however much room the card has."""
    for n_chunks, resident in ((64, 132), (512, 10_000), (1, 0)):
        a = spread_args(n_chunks, 16, noise=noise)
        plan_groups(a, form, resident)
        assert (a.groups, a.chunks_per_block) == (1, -(-n_chunks // a.cluster))
    a = spread_args(64, 16, noise=0)
    plan_groups(a, P1_GLOBAL, 10_000)
    assert a.groups == 1


@settings(max_examples=400, deadline=None)
@given(n_chunks=st.integers(1, 256), c_max=st.sampled_from([1, 8, 16]),
       batch=st.integers(1, 9), resident=st.integers(0, 400))
def test_spread_plan_bounds(n_chunks, c_max, batch, resident):
    """The global-weight forms' groups: at least 1; past 1, G * C <= n_chunks
    and batch * G * C <= resident, and G + 1 breaks one of the two (the most
    that fit); chunks_per_block over the G * C blocks."""
    a = spread_args(n_chunks, c_max, batch=batch)
    plan_groups(a, P1_GLOBAL, resident)
    G, C = a.groups, a.cluster
    assert G >= 1
    if G > 1:
        assert G * C <= n_chunks and batch * G * C <= resident
    assert (G + 1) * C > n_chunks or batch * (G + 1) * C > resident
    assert a.chunks_per_block == -(-n_chunks // (G * C))


@pytest.mark.parametrize("n_chunks, batch, resident, want", [
    (64, 1, 132, 4), (64, 2, 132, 4), (64, 4, 132, 2), (32, 1, 132, 2), (16, 1, 132, 1),
    (64, 9, 132, 1), (64, 1, 0, 1)])
def test_spread_plan_examples(n_chunks, batch, resident, want):
    """At 256 units and P=512 the whole solve's 64 chunks of 8 on a card of
    132 SMs (one block each): 4 clusters' worth a scenario for one or two
    scenarios, 2 for four; value_and_grad's 32 chunks 2; the P=128 floor's 16
    one cluster."""
    a = spread_args(n_chunks, 16, batch=batch)
    plan_groups(a, P1_GLOBAL, resident)
    assert a.groups == want


@settings(max_examples=400, deadline=None)
@given(n_chunks=st.integers(1, 256), c_max=st.sampled_from([1, 8, 16]),
       resident=st.integers(1, 400))
def test_scenario_chunks_cover_each_chunk_once(n_chunks, c_max, resident):
    a = spread_args(n_chunks, c_max)
    plan_groups(a, P1_GLOBAL, resident)
    mine = scenario_chunks(a)
    assert len(mine) == a.groups * a.cluster
    assert sorted(ch for block in mine for ch in block) == list(range(n_chunks))
    assert all(1 <= len(block) <= a.chunks_per_block for block in mine)
    assert max(len(block) for block in mine) == a.chunks_per_block


@pytest.mark.parametrize("n_chunks, c_max, resident", [(64, 16, 132), (32, 16, 132),
                                                       (40, 16, 132), (7, 2, 100)])
def test_slot_sum_is_the_one_block_serial_loop_in_fp32(n_chunks, c_max, resident):
    """The spread's sum, emulated in numpy float32: each of the scenario's
    blocks keeps its chunks' partials at their local index (chunk j + jj * N
    at jj), writes them to the chunk's slot, and every slot is summed in
    chunk order from 0.f; against one block sweeping the chunks in order.
    Partials spread over six decades, so another order (a block's chunks
    first, where a block has more than one) moves the bits."""
    rs = np.random.RandomState(n_chunks)
    n = 83
    part = (rs.standard_normal((n_chunks, n))
            * 10.0 ** rs.uniform(-3, 3, (n_chunks, 1))).astype(np.float32)
    serial = np.zeros(n, np.float32)
    for ch in range(n_chunks):
        serial = (serial + part[ch]).astype(np.float32)
    a = spread_args(n_chunks, c_max)
    plan_groups(a, P1_GLOBAL, resident)
    local = [part[block] for block in scenario_chunks(a)]     # each block's partials
    slots = np.full((n_chunks, n), np.nan, np.float32)
    for block, mine in zip(scenario_chunks(a), local):
        for jj, ch in enumerate(block):
            slots[ch] = mine[jj]
    acc = np.zeros(n, np.float32)
    for ch in range(n_chunks):
        acc = (acc + slots[ch]).astype(np.float32)
    assert np.array_equal(acc.view(np.int32), serial.view(np.int32))
    by_block = np.zeros(n, np.float32)
    for mine in local:
        by_block = (by_block + mine.sum(axis=0, dtype=np.float32)).astype(np.float32)
    if a.chunks_per_block > 1:          # a block-major order is another order
        assert not np.array_equal(by_block.view(np.int32), serial.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
def test_spread_is_bit_equal_to_one_cluster_on_cuda(repo_root, bf16, batch):
    """On the card, the iris traj config on a 256-unit trunk (the shipped
    one zero-padded), P=512 antithetic, with risk and starts: the whole
    solve at a fixed 5 iterations and ``value_and_grad`` at their planned
    spread, past one cluster's 16 blocks a scenario, give the bits of one
    cluster a scenario (``p1_step_ab.grouped(1)``) on every output, over
    ``batch`` scenarios in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spread forms are CUDA kernels")
    from sde4mbrl_px4_tpu_torch.engine.goldens import padded_trunk
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda import apg_kernel as AK
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian, draw_start_spread
    from sde4mbrl_px4_tpu_torch.p1_step_ab import flat, grouped

    dev = torch.device("cuda")
    b = load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"),
                              device=dev)[3]
    params = padded_trunk(b.params, 256)
    H, P, B = int(b.time_steps.shape[0]), 512, batch
    x0 = b.cost_params.uref.new_zeros((B, 13))
    x0[:, 6] = 1.0
    x0[:, 0] = 0.3 + 0.1 * torch.arange(B, device=dev)
    x_ref = x0[:, None].expand(B, H + 1, 13).contiguous()
    u_prev = b.cost_params.uref.expand(B, 4).contiguous()
    u_init = (u_prev[:, None] + 0.02).expand(B, H, 4).contiguous()
    z = torch.stack([draw_brownian(torch.Generator().manual_seed(i), H, P, True, dev)
                     .transpose(0, 1) for i in range(B)]).contiguous()
    z0 = draw_start_spread(torch.Generator().manual_seed(9), P, True, dev)
    starts = (x0[:, None] + 0.05 * z0[None]).contiguous()
    cp = b.cost_params._replace(risk_lambda=2.0)
    apg = b.apg_config._replace(max_iter=5, max_no_improvement_iter=5)
    args = (b.model, params, cp, apg, b.time_steps, x0, x_ref, u_prev, z, P, b.lb, b.ub, u_init)
    oargs = (b.model, params, cp, b.time_steps, x0, x_ref, u_prev, z, P, 4)

    def run():
        n0 = dict(AK.apg_solve_kernel.blocks_global), dict(CO.value_and_grad_kernel.blocks_global)
        st, xe = AK.apg_solve_kernel_batched(*args, precond=b.precond, starts=starts, bf16=bf16)
        v, g = CO.cost_oracle_batched(*oargs, starts=starts, bf16=bf16).value_and_grad(u_init)
        torch.cuda.synchronize()
        got = (AK.apg_solve_kernel.blocks_global, CO.value_and_grad_kernel.blocks_global)
        blocks = [max(n for n, k in new.items() if k > old.get(n, 0))
                  for new, old in zip(got, n0)]
        return [t.clone() for t in flat((st, xe, v, g))], blocks

    with grouped(1):
        one, n_one = run()
    spread, n_spread = run()
    assert n_one == [16, 16] and n_spread[0] > 16 and n_spread[1] > 16
    assert all(torch.equal(p, q) for p, q in zip(one, spread))
