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
  of the one-block serial chunk loop in fp32;
- ``value_batch``'s spread: ``plan_groups`` over the B x K plans (each a
  unit of groups * cluster blocks; MPPI's K = 64 at groups 1), each plan's
  chunks covered once, the scratch floats (``consts.spread_floats``) as
  ``csrc/apg_solve.cuh::spread_floats`` counts them over the plans, and
  the oracle's one chunk for both kernels in the global-weight forms (at
  most P // 64 rows, ``cost_oracle.GW_ORACLE_BLOCKS``, where ``value_batch``
  spreads at its solver's K; else the largest that fits).

``test_spread_is_bit_equal_to_one_cluster_on_cuda`` holds the planned
spread to one cluster a scenario bit for bit on the card, and
``test_value_batch_spread_is_bit_equal_to_one_cluster_on_cuda`` the same
for ``value_batch``'s plans (and the library's scratch floats against
``consts.spread_floats``); both skip without a card.
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
                                                    SPREAD_CTR, ApgArgs, plan_cluster,
                                                    plan_groups, scenario_chunks, spread_floats,
                                                    value_batch_grid)


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


@settings(max_examples=400, deadline=None)
@given(n_chunks=st.integers(1, 256), c_max=st.sampled_from([1, 8, 16]),
       batch=st.integers(1, 4), K=st.integers(1, 80), resident=st.integers(0, 400))
def test_value_batch_spread_plan_bounds(n_chunks, c_max, batch, K, resident):
    """``value_batch``'s groups over its B x K plans: past 1, G * C <=
    n_chunks and B * K * G * C <= resident (the cooperative grid the card
    holds at once), G + 1 breaks one of the two; each plan's blocks cover
    its chunks once (``scenario_chunks``)."""
    a = spread_args(n_chunks, c_max, batch=batch)
    plan_groups(a, P1_GLOBAL, resident, K)
    G, C = a.groups, a.cluster
    assert G >= 1
    if G > 1:
        assert G * C <= n_chunks and batch * K * G * C <= resident
    assert (G + 1) * C > n_chunks or batch * K * (G + 1) * C > resident
    assert a.chunks_per_block == -(-n_chunks // (G * C))
    mine = scenario_chunks(a)
    assert sorted(ch for block in mine for ch in block) == list(range(n_chunks))


@pytest.mark.parametrize("n_chunks, batch, K, want", [
    (64, 1, 1, 4), (32, 1, 1, 2), (64, 1, 4, 2), (64, 2, 1, 4), (64, 2, 4, 1), (16, 1, 1, 1),
    (16, 1, 64, 1), (64, 1, 64, 1)])
def test_value_batch_spread_plan_examples(n_chunks, batch, K, want):
    """On a card of 132 SMs (one block each): the 256-unit fixed-step
    route's K = 1 trial on 64 chunks of 8 spreads over 4 clusters' worth, on
    the parent's 32 chunks of 16 over 2; the linesearch's K = 4 over 2;
    MPPI's K = 64 grid fills the card at groups 1."""
    a = spread_args(n_chunks, 16, batch=batch)
    plan_groups(a, P1_GLOBAL, 132, K)
    assert a.groups == want


@settings(max_examples=200, deadline=None)
@given(H=st.integers(1, 40), nZ=st.integers(1, 12), K=st.integers(0, 8),
       n_chunks=st.integers(1, 128), groups=st.integers(1, 8), batch=st.integers(1, 4),
       plans=st.integers(1, 64))
def test_spread_scratch_floats_mirror_the_header(H, nZ, K, n_chunks, groups, batch, plans):
    """``consts.spread_floats`` against ``csrc/apg_solve.cuh::spread_floats``
    written out: 0 at groups 1; else per unit (a scenario, or for
    ``value_batch`` each of its plans: ``value_batch_scratch_floats``) a
    counter SPREAD_CTR words wide and two regions of n_chunks slots of
    max(H * nZ + 3, 3K) floats."""
    a = ApgArgs()
    a.H, a.nZ, a.K, a.n_chunks, a.groups, a.batch = H, nZ, K, n_chunks, groups, batch
    width = H * nZ + 3 if H * nZ + 3 > 3 * K else 3 * K
    want = 0 if groups == 1 else batch * plans * (SPREAD_CTR + 2 * n_chunks * width)
    assert spread_floats(a, plans) == want
    assert spread_floats(a, plans) == plans * spread_floats(a)


def test_spread_scratch_constants_match_the_header(repo_root):
    """The counter's width and the slot width in the header are the ones
    ``consts.spread_floats`` mirrors."""
    import re

    hdr = open(os.path.join(repo_root, "sde4mbrl_px4_tpu_torch/csrc/apg_solve.cuh")).read()
    assert int(re.search(r"#define SPREAD_CTR (\d+)", hdr).group(1)) == SPREAD_CTR
    assert "a.H * a.nZ + 3 > 3 * a.K ? a.H * a.nZ + 3 : 3 * a.K" in hdr
    assert "a.batch * (SPREAD_CTR + 2 * spread_region(a))" in hdr
    src = open(os.path.join(repo_root, "sde4mbrl_px4_tpu_torch/csrc/cost_oracle.cu")).read()
    assert "plans.batch = a->batch * K;" in src       # value_batch_scratch_floats' units


class FakeGlobalOracleLibrary(FakeOracleLibrary):
    """As FakeOracleLibrary, but no chunk fits the shared-memory forms (a
    wide trunk): the global-weight forms take the plan, their bytes growing
    with the chunk; ``value_batch`` holds ``resident`` blocks at once."""

    def __init__(self, vb_max, vg_max, resident=132):
        super().__init__(vb_max, vg_max)
        self.resident = resident

    def value_batch_smem_bytes(self, a, K):
        return 10 ** 9 if a._obj.step == P1_SMEM else 2000 * a._obj.Pc

    def value_and_grad_smem_bytes(self, a):
        return 10 ** 9 if a._obj.step == P1_SMEM else 9000 * a._obj.Pc

    def oracle_part_form(self, a, kind):
        return P1_GLOBAL

    def value_batch_resident_blocks(self, a, n):
        n._obj.value = self.resident
        return 0


@pytest.mark.parametrize("P, plans, batch, want", [
    (512, 1, 1, (8, 64)), (512, 64, 1, (16, 32)), (512, 1, 8, (16, 32)), (128, 1, 1, (16, 8)),
    (256, 1, 1, (8, 32)), (1024, 1, 1, (16, 64)), (48, 1, 1, (24, 2))])
def test_oracle_global_weight_chunk_is_one_for_both(monkeypatch, P, plans, batch, want):
    """The oracle's chunk in the global-weight forms: where ``value_batch``
    spreads at K = ``plans`` over the B x K plans (two clusters' worth of
    chunks a plan and of blocks on the card each), at most max(P //
    GW_ORACLE_BLOCKS, GW_MIN_ROWS) rows (the largest divisor of P that fits
    both kernels at or below it), so a K = 1 plan of P=512 has 64 chunks for
    the spread; where it stays at one cluster a plan (MPPI's K = 64, eight
    scenarios, or too few chunks) the largest chunk that fits (16 here, the
    256-unit trunk's before). One chunk for both kernels; the form asked of
    the libraries stays the shape's."""
    lib = FakeGlobalOracleLibrary(16, 16)
    monkeypatch.setattr(CO, "load_oracle_library", lambda *args, **kw: lib)
    a = ApgArgs()
    a.step, a.batch = P1_BY_SHAPE, batch
    CO.plan_oracle_particles(lib, a, P, 0, plans=plans)
    assert (a.Pc, a.n_chunks) == want and a.Pc * a.n_chunks == P
    assert a.step == P1_BY_SHAPE


def test_grouped_pins_value_batch_plans_at_one_cluster():
    """``p1_step_ab.grouped(g)`` pins every spread plan, ``value_batch``'s
    over its K plans too, at g clusters' worth a unit (or fewer where the
    chunks run out)."""
    from sde4mbrl_px4_tpu_torch.p1_step_ab import grouped

    for g, K, want in ((1, 1, 1), (1, 4, 1), (2, 4, 2), (8, 1, 4)):
        a = spread_args(64, 16)
        with grouped(g):
            CO.plan_groups(a, P1_GLOBAL, 10 ** 6, K)
        assert a.groups == want


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_value_batch_spread_is_bit_equal_to_one_cluster_on_cuda(repo_root, bf16):
    """On the card, the iris posctrl config on a 256-unit trunk (the shipped
    one zero-padded), P=512 antithetic, with risk and starts, two scenarios:
    ``value_batch`` at K = 1 and 4 and its moments-out form at their planned
    spread (K = 1 past one cluster's 16 blocks a plan) give the bits of one
    cluster a plan (``p1_step_ab.grouped(1)``); the library's scratch floats
    are ``consts.spread_floats`` over the plans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spread forms are CUDA kernels")
    import ctypes

    from sde4mbrl_px4_tpu_torch.engine.goldens import padded_trunk
    from sde4mbrl_px4_tpu_torch.engine.mpc_loader import load_mpc_from_cfgfile
    from sde4mbrl_px4_tpu_torch.ops.cuda.consts import build_consts
    from sde4mbrl_px4_tpu_torch.ops.rollout import draw_brownian, draw_start_spread
    from sde4mbrl_px4_tpu_torch.p1_step_ab import flat, grouped

    dev = torch.device("cuda")
    b = load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"),
                              device=dev)[3]
    params = padded_trunk(b.params, 256)
    H, P, B = int(b.time_steps.shape[0]), 512, 2
    x0 = b.cost_params.uref.new_zeros((B, 13))
    x0[:, 6] = 1.0
    x0[:, 0] = 0.3 + 0.1 * torch.arange(B, device=dev)
    x_ref = x0[:, None].expand(B, H + 1, 13).contiguous()
    u_prev = b.cost_params.uref.expand(B, 4).contiguous()
    z = torch.stack([draw_brownian(torch.Generator().manual_seed(i), H, P, True, dev)
                     .transpose(0, 1) for i in range(B)]).contiguous()
    z0 = draw_start_spread(torch.Generator().manual_seed(9), P, True, dev)
    starts = (x0[:, None] + 0.05 * z0[None]).contiguous()
    cp = b.cost_params._replace(risk_lambda=2.0)
    U = (u_prev[:, None, None] + 0.05 * torch.rand((B, 4, H, 4), device=dev,
         generator=torch.Generator(device=dev).manual_seed(3))).contiguous()

    def run():
        n0 = dict(CO.value_batch_kernel.blocks_global)
        o = CO.cost_oracle_batched(b.model, params, cp, b.time_steps, x0, x_ref, u_prev, z, P,
                                   4, starts=starts, bf16=bf16)
        outs = [o.value_batch(U[:, :1].contiguous()), o.value_batch(U),
                o.value_batch_moments(U[:, :1].contiguous()), o.value_batch_moments(U)]
        torch.cuda.synchronize()
        new = CO.value_batch_kernel.blocks_global
        return [t.clone() for t in flat(outs)], sorted(n for n, k in new.items()
                                                       if k > n0.get(n, 0))

    with grouped(1):
        one, n_one = run()
    spread, n_spread = run()
    assert n_one == [16] and max(n_spread) > 16
    assert all(torch.equal(p, q) for p, q in zip(one, spread))
    _, a = build_consts(b.model, params, cp, None, b.time_steps, x0[0], x_ref[0], u_prev[0],
                        particles=True)
    a.batch, a.has_starts, a.bf16 = B, 1, int(bf16)
    CO.plan_oracle_particles(CO.load_oracle_library(), a, P, 0)
    for K, groups in ((1, 4), (4, 2)):
        a.groups = groups
        assert CO.load_oracle_library(True).value_batch_scratch_floats(
            ctypes.byref(a), K) == spread_floats(a, K)


@pytest.mark.parametrize("solver, want", [("mppi", 16), ("apg", 1)])
def test_loader_plans_the_oracle_for_its_solvers_k(repo_root, monkeypatch, solver, want):
    """The loader builds the oracle of a route for the K of most of its
    solver's ``value_batch`` launches (``cost_oracle_batched``'s ``plans``,
    which the particle chunk is planned for): MPPI's samples, 1 for the
    fixed-step APG route's gradient and value."""
    from sde4mbrl_px4_tpu_torch.core.types import hover_state
    from sde4mbrl_px4_tpu_torch.engine import mpc_loader as ML
    from sde4mbrl_px4_tpu_torch.io.config import load_yaml_config

    seen = []
    real = ML.cost_oracle_batched

    def spy(*args, **kw):
        seen.append(kw.get("plans"))
        return real(*args, **kw)

    monkeypatch.setattr(ML, "cost_oracle_batched", spy)
    cfg = load_yaml_config(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))
    cfg["solver"] = solver
    cfg["mppi"] = {"samples": 16, "iters": 1}
    del cfg["apg_mpc"]["linesearch"]
    cfg["apg_mpc"].update(stepsize=1e-5, max_iter=2, max_no_improvement_iter=2)
    _, (reset_fn, mpc_fn), _, _ = ML.make_mpc_from_config(cfg, device="cpu")
    x0 = hover_state(torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    u = mpc_fn(x0, gen, reset_fn(x0, gen, x0), 0.0, x0)[0]
    assert bool(torch.isfinite(u).all())
    assert seen and set(seen) == {want}
