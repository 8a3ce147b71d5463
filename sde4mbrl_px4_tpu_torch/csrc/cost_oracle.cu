// Cost-oracle kernels for Hopper (sm_90a): the three evaluations of
// sde4mbrl_px4_tpu/ops/pallas/solve_kernels.py::pallas_cost_oracle that a
// solver outside the whole-solve kernel calls.
//
//   value_batch     K candidate plans -> K costs        (pallas_call :276,
//                   run_candidates + control_cost of bodies.py)
//   value_and_grad  one plan -> cost and (H, nZ) gradient (pallas_call :297,
//                   vg_sweep of bodies.py)
//   trajectory      one plan -> mean rollout (H+1, 13)   (pallas_call :347)
//
// Each takes a.batch scenarios per launch (apg_solve.cuh, batch): B
// problems that share the trunk and the cost but not their consts (x0, the
// reference, u_prev), plans or Brownian block. The P=1 value_batch puts
// scenario b on row b of its grid's y dimension (the blocks of its K
// candidates); the particle value_batch runs a flat grid of B x K clusters,
// cluster i candidate i % K of scenario i / K; value_and_grad and
// trajectory take block b (P=1) or cluster b (particles). Per-scenario data
// lies at b times its stride, and no value crosses scenarios, so a
// scenario's bits are those of its solo launch (B = 1). The P=1 forms and
// value_and_grad read the scenario index from its special register where
// it is used (grid_row, vg_scenario), so that no register holds it across
// the step chain. The batched solves of the oracle routes
// (parallel/batched.py: MPPI over B x K plans, fixed-step APG, the policy's
// telemetry cost) make one launch per evaluation over all B scenarios.
//
// value_batch and value_and_grad are templates <PART, SC>: PART = false the
// deterministic P=1 oracle (mean dynamics), PART = true the Monte-Carlo one
// (has_noise): P particles in n_chunks passes of Pc rows, the Brownian
// block (H, P, 13) read from device memory per step, costs the particle
// mean (a mean of chunk means, K11); SC the state_constr form (CONSTR_NONE,
// CONSTR_PENALTY, CONSTR_PROX), which adds make_step's constraint terms
// (bodies.py:188-206) to every stage cost and their cotangents to the
// reverse sweep, and in the proximal form reads nZ = n_u + m wide plans
// whose control terms cover the first n_u columns (bodies.py:413-415, :485).
// All six pairs are instantiated; CONSTR_NONE compiles to the code the
// kernels had before the constraint forms existed. trajectory is always
// the mean dynamics of the control columns (solve_kernels.py:319-332), at
// any nZ. The step, sweep and cost device code is sweeps.cuh, shared with
// the whole-solve kernel (apg_solve.cu), so the two paths compute the same
// numbers.
//
// What bounds them on this card: latency. A step is a (9+n_u)->64->64->12
// MLP plus rigid-body math, serial over the H steps; one plan is ~0.2 MFLOP
// forward per particle. What the design does about it: each block copies
// the 24.9 KB consts buffer into shared memory once and keeps every
// intermediate there or in registers, and:
//   - at P=1 the three kernels run the step chain of the whole solve's P=1
//     forms (sweeps.cuh, P1W / p1_rollout: the trunk in registers, split-K
//     layer 1, a row's scalar step in the 32 lanes of its warp, two block
//     barriers per step). value_and_grad is the vg row forward and reverse
//     (sweeps.cuh::vg); value_batch takes up to ORACLE_P1_ROWS = 8
//     candidates per 256-thread block, one warp each, as the whole solve
//     takes its linesearch candidates, in ceil(K / 8) blocks in parallel
//     (the TPU package sends K > 128 to XLA only because of its VMEM);
//     trajectory is one row whose states the chain stashes. The register
//     layout takes HID = 64 and F <= 16 only: other trunks run the P=1
//     shared-memory step (P1_SMEM / P1_GLOBAL, chosen by shape, p1_form_of:
//     value_batch<false, SC, false> and trajectory<false> on fwd_step<false>,
//     a thread per trunk output, ORACLE_TILE rows per value_batch block;
//     value_and_grad<false, SC, ..., STEP> on the whole solve's wide step,
//     sweeps.cuh::vg_wide: the chain's structure over a runtime width, layer
//     1 split over the block's warps), their
//     weights in the block's consts copy up to 227 KB of dynamic shared
//     memory (cost_oracle_init) and past that read from device memory
//     (P1_GLOBAL, the GW forms: scenario 0's trunk, L2-resident; the same
//     bits, up to 30 % slower where both fit);
//   - with particles the chunks of a plan spread over a thread-block
//     cluster, one block per SM (sweeps.cuh::vg_part / cand_part: block
//     `rank` sweeps chunks rank, rank + C, ..., and every block sums all
//     chunks' partials in chunk order through distributed shared memory, so
//     every C gives the bits of C = 1): value_and_grad is one cluster,
//     value_batch a grid of K clusters, one per candidate, rank 0 writing
//     the candidate's cost; each takes dynamic shared memory above 48 KB
//     (set once per library load by cost_oracle_init), and the wrapper
//     picks the largest divisor Pc of P whose layouts both fit. The
//     candidate rows' trunk products are register tiles (rows_gemm, as in
//     the whole solve), whose sums run in the order of a thread per output.
// The constraint terms add per-row scalar work to each step and no memory
// traffic; at nZ > n_u a P=1 value_batch block takes fewer rows only where
// its wider rows would pass 48 KB. The particle forms take the particle
// options of the whole solve (sweeps.cuh, Risk): a.risk prices each plan at
// mean + lambda * std of its particles' discounted totals (value_and_grad's
// gradient with the rows' risk weights), and `starts` (B, P, 13), when not
// null, gives each particle its initial state (scenario b's at b * P * 13);
// MPPI's K candidates on P shared paths are one particle value_batch launch
// of K (x B) clusters. The TPU package sends all three to XLA
// (engine/mpc_loader.py:342-350, :434-443). The options are a template
// parameter OPT of the particle forms: the forms without them compile to
// the code they had before, and a launch with risk or starts takes the
// OPT = true form (value_batch_kernel<true, SC, false, true>,
// value_and_grad_kernel<true, SC, true>).
//
// Risk over the blocks of particles of a sharded solve (ApgArgs::risk_mode,
// apg_solve.cuh RISK_*; the template parameter RM of the OPT forms, whose
// default RISK_IN_CLUSTER compiles to the code they had): a process holds
// P/mc of the P particles, so the moments of the totals over all P are not
// in its cluster. value_batch's RISK_MOMENTS_OUT form writes each plan's
// risk-free cost, the mean of its totals and their centred second moment
// over the launch's particles, (B, K, 3) into `out`, and the host combines
// the blocks' triples (cost/cost.py::combine_risk_moments);
// value_and_grad's RISK_MOMENTS_IN form reads each scenario's (m, std) over
// all P from `moments` (B, 2) and weighs its rows with them, each chunk's
// reverse right after its own forward (sweeps.cuh, Risk).
//
// Trunks past the particle forms' shared memory (apg_solve.cuh, part_form;
// past 144 units at P=512 on the iris configs, whose trunk and transposes
// take 196 KB of a block's 227 KB): the global-weight forms of value_batch
// and value_and_grad (GW; sweeps.cuh) read the weights in place from
// scenario 0's consts in device memory, keep no transposes and copy only the
// consts before the trunk. They are the options forms and their
// shared-moments forms (risk and starts runtime branches, off without them),
// fp32 and bf16, in a library of their own (cost_oracle_gw.cu, built in
// parallel), each taken by shape per kernel: value_batch keeps its
// shared-memory form wherever its own block fits with the planned chunk.
// Both forms give the same bits. What bounds value_and_grad's: the trunk's
// FLOPs on the SMs it gets, then the weights' reads from L2; one cluster
// gives a plan at most 16 SMs (64 chunks of 8 rows at 256 units, P=512).
// So it spreads a scenario over ApgArgs::groups clusters' worth of plain
// blocks of a cooperative grid (sweeps.cuh, the spread note; the planner
// sizes it to what the card holds at once, ops/cuda/consts.py::
// plan_groups), each chunk's partials in a slot in device memory, summed in
// chunk order by every block after a barrier over the scenario's blocks:
// the bits of one cluster. value_batch's global-weight form spreads each of
// its B x K plans the same way (a plan a spread unit: groups * cluster
// blocks each, planned over the B x K plans), so a K = 1 trial of the
// fixed-step route gets up to the card's SMs; MPPI's K = 64 grid already
// fills the card and plans groups 1.
//
// Reduced matmul precision (ApgArgs::bf16, sweeps.cuh): the bf16-trunk
// instantiations (BF) of value_batch (the particle forms and the P=1 ones,
// value_batch_kernel<PART, SC, REG, OPT, true>) and of value_and_grad's
// particle forms (value_and_grad_kernel<true, SC, OPT, true>); a launch
// with a.bf16 takes them. Each block rounds the trunk weights of its
// consts copy once (load_block) and the sweeps store the products' other
// operands rounded; the forms without BF compile to the code they had. The
// JAX package runs these on XLA (MPPI at P > 1 or K > 128, the pure
// policy's telemetry cost, P > 128): engine/mpc_loader.py:320-350,
// :434-445. The P=1 value_and_grad refuses it (the original's P=1 oracle is
// its kernel, at HIGHEST), and trajectory has no bf16 form: x_evol is the
// fp32 mean rollout (:815-819).
//
// Control flow is block-uniform and every __syncthreads() is reached by all
// threads of the block.

#include <cuda_runtime.h>

#include "apg_solve.cuh"
#include "cost_oracle.cuh"
#include "sweeps.cuh"

// 1: the library of the particle forms' global-weight forms
// (cost_oracle_gw.cu: value_batch's and value_and_grad's options forms and
// their shared-moments forms, fp32 and bf16, with the trunk's weights read in
// device memory).
#ifndef ORACLE_GW
#define ORACLE_GW 0
#endif
// 1: the library of the P=1 forms of the three kernels (cost_oracle_p1.cu:
// value_batch on the register chain and the shared-memory step,
// value_and_grad on the register chain and the wide step, its forms over
// more than P1_FMAX inputs among them, trajectory); 0 with ORACLE_GW 0 the
// cluster particle forms of value_batch and value_and_grad. nvcc builds the
// three in parallel.
#ifndef ORACLE_P1
#define ORACLE_P1 0
#endif

namespace {

static_assert(ORACLE_TILE <= 32 && ORACLE_P1_ROWS <= 32, "one red slot per row");
static_assert(ORACLE_TILE <= ORACLE_NTHREADS, "fwd_step: one thread per row");
static_assert(ORACLE_NTHREADS == 4 * P1_HID && ORACLE_P1_ROWS <= ORACLE_NTHREADS / 32,
              "P=1 register chain: 4 threads per hidden unit, one warp per row");
static_assert(ORACLE_NTHREADS == APG_NTHREADS, "the P=1 wide step: kSlices warps a block");

// The block's scenario, read where it is used (asm volatile: never
// hoisted), so that no register holds it, or a pointer offset by it, across
// the step chain: the P=1 value_batch's grid row, value_and_grad's block
// (P=1) or cluster (particles).
__device__ __forceinline__ size_t grid_row() {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(b));
  return b;
}
template <bool PART>
__device__ __forceinline__ size_t vg_scenario() {
  unsigned b;
  if constexpr (PART) asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(b));
  else asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}
// ... and with the spread (the global-weight form; sweeps.cuh) its blocks'
// scenario
template <bool PART, bool SPREAD>
__device__ __forceinline__ size_t vg_scen(const ApgArgs& a) {
  if constexpr (SPREAD) return spread_scenario(a);
  else return vg_scenario<PART>();
}

// Carve one block's dynamic shared memory for `kind` with R candidate rows
// of controls; returns the number of floats used. part: the particle form
// (R*Pc step rows per pass, a Pc-row state stash and reverse sweep in
// value_and_grad). step: the P=1 form (P1_*; a kernel's template constant).
// On the register chain every buffer starts on 16 bytes (its float4 reads)
// and a row's state, features and outputs live in registers; trajectory and
// value_and_grad then stash the row's states, pre-activations and wrench.
// On the P=1 step forms value_and_grad runs the wide step (sweeps.cuh,
// vg_wide), which stashes the row's states, pre-activations, outputs and
// wrench and keeps layer 1's slice sums and the transposed output layer
// here; P1_GLOBAL
// copies only the consts before the trunk's weights; with part it is the
// global-weight form (no weights and no transposes here; value_and_grad's
// reverse cotangents at row stride tiled_ld, sweeps.cuh::bwd_rows), any
// other step the shared-memory form. risk: the risk buffers (a constant
// false in the forms without the options). Fields a kernel does not use stay
// null. far (value_and_grad's wide step with the weights in device memory,
// vg_far): the wide step's width-sized buffers (h0p, h1p, pp, w2t) are
// carved from fbase, the scenario's region of the launch's scratch in
// device memory; *n_far (if given) their floats.
__host__ __device__ inline int layout(const ApgArgs& a, int kind, int R, bool part, bool risk,
                                      Smem* s, float* base, int step, bool far = false,
                                      float* fbase = nullptr, int* n_far = nullptr) {
  const int HZ = a.H * a.nZ;
  const int rows = part ? R * a.Pc : R;       // step rows per pass
  const int B = part ? a.Pc : 1;              // value_and_grad rows per pass
  // the register chain also tests the widths at run time (its launches
  // hold them, p1_form_ok): the chain forms' code and times depend on it
  const bool reg = !part && step == P1_CHAIN && p1_widths(a);
  // the hidden row stride: the particle value_batch's rows are tiled
  const int ldh = part && kind == ORACLE_VALUE_BATCH ? tiled_ld(a) : a.HID;
  const bool gw = step == P1_GLOBAL;          // the weights in device memory
  const int ldc = part && gw ? tiled_ld(a) : a.HID;   // reverse cotangents' row stride
  // value_and_grad on the P=1 wide step (a kernel's constant STEP, so that
  // the register chain's forms compile to the code they had)
  const bool wide = kind == ORACLE_VALUE_AND_GRAD && !part && step != P1_CHAIN;
  int o = 0, of = 0;
  auto take = [&](float** p, int n) {
    if (reg) o = (o + 3) & ~3;
    if (s) *p = base + o;
    o += n;
  };
  auto take_far = [&](float** p, int n) {
    if (s) *p = fbase + of;
    of += n;
  };
  Smem d = {};
  Smem* t = s ? s : &d;
  take(&t->c, gw ? a.o_w0 : a.n_consts);
  take(&t->cand, R * HZ);
  if (!reg && !wide) { take(&t->xr, rows * 13); take(&t->feat, rows * a.F); }
  take(&t->a0, rows * ldh);
  if (!wide) take(&t->a1, rows * ldh);
  if (!reg && !wide) take(&t->a2, rows * a.OUT);
  take(&t->jt, rows); take(&t->jr, rows);
  take(&t->red, 32);
  if (kind != ORACLE_VALUE_BATCH) take(&t->xs, (a.H + 1) * B * 13);
  if (reg && kind != ORACLE_VALUE_BATCH) {
    take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
    take(&t->h2, a.H * a.OUT); take(&t->wr, a.H * 4);
  }
  if (kind == ORACLE_VALUE_AND_GRAD) {
    if (part) { take(&t->p0, B * a.HID); take(&t->p1, B * a.HID); }
    take(&t->g, HZ);
    if (part) take(&t->ct, B * 13);              // P=1: the row's cotangents in
    take(&t->cu, B * a.nZ);                      // registers (p1_reverse)
    if (part) take(&t->c_h2, B * a.OUT);
    take(&t->c_h1p, B * ldc); take(&t->c_h0p, B * ldc);
    if (part) {
      take(&t->c_feat, B * a.F);
      if (!gw) {
        take(&t->w0t, a.F * a.HID); take(&t->w1t, a.HID * a.HID);
        take(&t->w2t, a.OUT * a.HID);
      }
    }
    // a chain form's row on other widths: a launch never takes it (p1_form_ok
    // refuses the chain off its widths); it stays for register parity, as
    // without it ptxas gave the chain forms other code and registers
    if (!part && !reg && !wide) {
      take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
      take(&t->h2, a.H * a.OUT);
      take(&t->ct, 13); take(&t->c_h2, a.OUT); take(&t->c_feat, a.F);
    }
    if (wide && far) {                          // the wide step's vg row
      take_far(&t->h0p, a.H * a.HID); take_far(&t->h1p, a.H * a.HID);
      take(&t->h2, a.H * a.OUT); take(&t->wr, a.H * 4);
      take_far(&t->pp, kSlices * a.HID); take_far(&t->w2t, a.OUT * a.HID);
    } else if (wide) {
      take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
      take(&t->h2, a.H * a.OUT); take(&t->wr, a.H * 4);
      take(&t->pp, kSlices * a.HID); take(&t->w2t, a.OUT * a.HID);
    }
  }
  const int np = risk ? 3 : 2;                // the partial means (risk: + totals)
  // value_batch with risk: + the centred second moments a moments-out form
  // writes out
  if (part) take(&t->cacc, (kind == ORACLE_VALUE_BATCH && risk ? 4 : np) * R);
  // a block's chunk partials: value_and_grad's gradient and 2 costs (+ the
  // totals' mean with risk), the candidates' 2R (3R) means
  if (part && kind == ORACLE_VALUE_AND_GRAD) take(&t->pg, a.chunks_per_block * (HZ + np));
  if (part && kind == ORACLE_VALUE_BATCH) take(&t->pk, a.chunks_per_block * np * R);
  // risk: the rows' discounted totals of this block's chunks
  if (part && risk) take(&t->tot, a.chunks_per_block * rows);
  if (n_far) *n_far = of;
  return o;
}

// Whether a P=1 value_and_grad of a in form `step` keeps the wide step's
// width-sized buffers in device memory (layout's far): in the global-weight
// form where its block, the 4-byte static value included, would not fit
// 227 KB with them (past 896 units on the traj configs). The sums run in
// the same order, so the bits are the same.
__host__ __device__ inline bool vg_far(const ApgArgs& a, int step) {
  return step == P1_GLOBAL &&
         layout(a, ORACLE_VALUE_AND_GRAD, 1, false, false, nullptr, nullptr, P1_GLOBAL) *
                 (int)sizeof(float) + (int)sizeof(float) > ORACLE_SMEM_LIMIT_PARTICLES;
}

// Floats of one scenario's region of the scratch with layout's far.
__host__ __device__ inline int vg_far_floats(const ApgArgs& a) {
  int n = 0;
  layout(a, ORACLE_VALUE_AND_GRAD, 1, false, false, nullptr, nullptr, P1_GLOBAL, true, nullptr,
         &n);
  return (n + 3) & ~3;
}

// Copy the consts and R rows of controls (row r of the block at U + r*HZ)
// into shared memory; on the shared-memory step also start each row at x0
// with zero running costs. BF: the trunk weights of the copy rounded to
// bf16. GW (P1_GLOBAL): only the consts before the trunk's weights (the
// trunk reads them in device memory, rounded there in the bf16 forms).
template <bool BF = false, bool GW = false>
__device__ void load_block(const ApgArgs& a, const Smem& s, int R,
                           const float* __restrict__ consts,
                           const float* __restrict__ U) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < (GW ? a.o_w0 : a.n_consts); i += nt) s.c[i] = consts[i];
  if constexpr (BF && !GW) {
    __syncthreads();
    round_trunk_weights(a, s.c);
  }
  for (int e = tid; e < R * a.H * a.nZ; e += nt) s.cand[e] = U[e];
  if (s.xr) {
    for (int e = tid; e < R * 13; e += nt) s.xr[e] = consts[a.o_x0 + e % 13];
    if (tid < R) { s.jt[tid] = 0.f; s.jr[tid] = 0.f; }
  }
  __syncthreads();
}

// The costs of K plans U (B, K, H, nZ) into out (B, K) for B = a.batch
// scenarios (consts, plans, Brownian block and costs at b times their
// stride). PART: a grid of B x K clusters of a.cluster blocks, cluster i =
// blockIdx.x / cluster sweeping the chunks of plan i (candidate i % K of
// scenario i / K; cand_part), rank 0 writing its cost. P=1: scenario b on
// grid row b, block x taking its candidates x*tile .. x*tile + tile-1, REG
// on the register chain (p1_rollout, warp r the block's row r), else on the
// shared-memory step. BF: the bf16 trunk.
// The particle form states a minimum of one 512-thread block per SM (its
// 100-128 registers a thread allow no second): without it, ptxas took the
// proximal form to 64 registers (two blocks per SM) and a 108-byte spill
// once the scenario offsets were added. RM (PART and OPT): RISK_MOMENTS_OUT
// writes plan i's risk-free cost, the mean of its totals and their centred
// second moment to out[3i ..] (out (B, K, 3)). GW (not REG): the trunk's
// weights in device memory (scenario 0's): at P=1 the shared-memory step's
// P1_GLOBAL, with particles the global-weight form (the options forms only;
// apg_solve.cuh, part_form), which spreads each plan's chunks over
// a.groups * a.cluster blocks (sweeps.cuh, the spread note): plan i on
// blocks i*N .. i*N + N-1, its chunk partials summed through its slots of
// `scratch` (value_batch_scratch_floats) where groups > 1, so that a K = 1
// plan gets up to the card's SMs, not one cluster's 16, with the bits of one
// cluster.
template <bool PART, int SC, bool REG, bool OPT = false, bool BF = false,
          int RM = RISK_IN_CLUSTER, bool GW = false>
__global__ void __launch_bounds__(PART ? ORACLE_NTHREADS_PART : ORACLE_NTHREADS, PART ? 1 : 0)
value_batch_kernel(int K, int tile, ApgArgs a, const float* __restrict__ consts,
                   const float* __restrict__ U, const float* __restrict__ noise,
                   const float* __restrict__ starts, float* __restrict__ out,
                   float* __restrict__ scratch) {
  static_assert(!(PART && REG), "the register chain is the P=1 forms'");
  static_assert(RM == RISK_IN_CLUSTER || RM == RISK_MOMENTS_OUT, "value_batch writes moments");
  static_assert(RM == RISK_IN_CLUSTER || (PART && OPT), "the moments are the options forms'");
  static_assert(!GW || (!REG && (!PART || OPT)),
                "global weights are the shared-memory step's and the particle options forms'");
  // the particle global-weight form spreads each plan over a.groups *
  // a.cluster blocks (plan i = block / N)
  constexpr bool SPREAD = PART && GW;
  extern __shared__ __align__(16) float smem[];
  Smem s = {};
  layout(a, ORACLE_VALUE_BATCH, tile, PART, OPT && a.risk, &s, smem,
         REG ? P1_CHAIN : GW ? P1_GLOBAL : P1_SMEM);
  const int HZ = a.H * a.nZ, nZ = a.nZ;
  const int k0 = SPREAD ? (int)spread_scenario(a)
                 : PART ? (int)blockIdx.x / a.cluster : (int)blockIdx.x * tile;
  const int R = PART ? 1 : min(tile, K - k0);
  const int tid = threadIdx.x, warp = tid >> 5, nw = blockDim.x >> 5;
  const float* c = s.c;
  // PART: k0 is the flat plan index over B x K, so the plans and costs
  // need no scenario offset, the consts and the Brownian block k0 / K's
  if constexpr (PART)
    load_block<BF, GW>(a, s, R, consts + (size_t)(k0 / K) * a.n_consts, U + (size_t)k0 * HZ);
  else
    load_block<BF, GW>(a, s, R, consts + grid_row() * a.n_consts,
                       U + (grid_row() * K + k0) * (size_t)HZ);

  if constexpr (PART) {
    if constexpr (SPREAD) {
      __shared__ Spread sp;
      spread_init(a, s, &sp, scratch, (size_t)a.batch * K);    // a unit a plan
    }
    // OPT: scenario k0 / K's starts (null: x0), offset once into shared
    // memory, so that no register holds the pointer across the sweep
    __shared__ const float* starts_p;
    if constexpr (OPT) {
      if (tid == 0) starts_p = starts ? starts + (size_t)(k0 / K) * ((size_t)a.P * 13) : nullptr;
      __syncthreads();
    }
    if constexpr (GW) s.wg = consts;        // scenario 0's trunk, read in place
    cand_part<SC, false, OPT, BF, RM, GW, SPREAD>(
        a, s, 1, noise + (size_t)(k0 / K) * ((size_t)a.H * a.P * 13),
        [&]() -> const float* { return starts_p; });
    if constexpr (SPREAD) {
      if (spread_rank(a) != 0) return;
    } else if (cg::this_cluster().block_rank() != 0) {
      return;
    }
  } else if constexpr (REG) {
    p1_rollout<SC, false, false, BF>(a, s, load_p1_weights(a, c), R, s.cand, HZ);
  } else {
    for (int t = 0; t < a.H; ++t)
      fwd_step<false, SC, false, BF, GW>(a, s, R, s.cand + t * nZ, HZ, 1, nullptr, s.xr, s.xr,
                                         t, nullptr, nullptr, consts);
  }

  // control-only cost per row, one warp per row
  const float* scal = c + a.o_scal;
  for (int r = warp; r < R; r += nw) {
    const float* Ur = s.cand + r * HZ;
    warp_reduce_to(HZ, [&](int e) {
      const CtrlTerms ct = ctrl_terms<SC>(a, c, Ur, e);
      float cc = scal[SC_UERR] * ct.u + scal[SC_SLEW] * ct.sl;
      if (a.has_slew) cc = cc + scal[SC_SLEWC] * ct.viol;
      return cc;
    }, s.red + r);
  }
  __syncthreads();
  const float* cost_t = PART ? s.cacc : s.jt;
  const float* cost_r = PART ? s.cacc + R : s.jr;
  if (tid < R) {
    const float f = (cost_t[tid] + scal[SC_RESM] * cost_r[tid]) + s.red[tid];
    if constexpr (RM == RISK_MOMENTS_OUT) {
      // R = 1: cand_part's K = 1 leaves the totals' mean in s.cacc[2] and
      // their centred second moment in s.cacc[3]
      float* o = out + 3 * (size_t)k0;
      o[0] = f;
      o[1] = s.cacc[2];
      o[2] = s.cacc[3];
    } else {
      float* o = out + k0 + tid;
      if constexpr (!PART) o += grid_row() * K;
      *o = f;
    }
  }
}

// The mean rollout of one plan's control columns into x_out (H+1, 13): REG
// the register chain's row with its states stashed, else the shared-memory
// step (GW: its weights in device memory, scenario 0's) with the hidden and
// output layers' sums compensated (sweeps.cuh, trunk's DOT2): one running
// sum over a wide trunk's 1024 inputs left the rollout further from its
// float64 value than the reference's cuBLAS order, past the reference's
// tolerance. Block b rolls scenario b of a.batch: its consts (n_consts),
// plan (H, nZ) and output (H+1, 13) at b times their stride.
template <bool REG, bool GW = false>
__global__ void __launch_bounds__(ORACLE_NTHREADS)
trajectory_kernel(ApgArgs a, const float* __restrict__ consts,
                  const float* __restrict__ u, float* __restrict__ x_out) {
  static_assert(!(REG && GW), "global weights are the shared-memory step's");
  extern __shared__ __align__(16) float smem[];
  Smem s = {};
  layout(a, ORACLE_TRAJECTORY, 1, false, false, &s, smem,
         REG ? P1_CHAIN : GW ? P1_GLOBAL : P1_SMEM);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t scen = blockIdx.x;
  const float* const wb = consts;
  consts += scen * a.n_consts;
  u += scen * ((size_t)a.H * a.nZ);
  x_out += scen * ((size_t)(a.H + 1) * 13);
  load_block<false, GW>(a, s, 1, consts, u);
  if (tid < 13) s.xs[tid] = s.c[a.o_x0 + tid];
  if constexpr (REG) {
    p1_rollout<CONSTR_NONE, true, false>(a, s, load_p1_weights(a, s.c), 1, s.cand, 0);
    __syncthreads();
  } else {
    __syncthreads();
    for (int t = 0; t < a.H; ++t)
      fwd_step<false, CONSTR_NONE, false, false, GW, true>(a, s, 1, s.cand + t * a.nZ, 0, 1,
                                                           nullptr, s.xs + t * 13,
                                                           s.xs + (t + 1) * 13, t, nullptr,
                                                           nullptr, wb);
  }
  for (int e = tid; e < (a.H + 1) * 13; e += nt) x_out[e] = s.xs[e];
}

// The cost of one plan and its gradient, for scenario b = block b (P=1) or
// cluster b (particles): its consts, plan u (H, nZ), Brownian block, value
// and gradient (H, nZ) at b times their stride. BF (particles): the bf16
// trunk. RM (PART and OPT): RISK_MOMENTS_IN weighs the rows with the
// scenario's mean and std of the totals over all particles, moments[2b ..]
// (moments (B, 2)), and val is then its risk-free cost over these
// particles. STEP: at P=1 the P=1 form (P1_*), the register chain or the
// wide step on any trunk (sweeps.cuh::vg_wide; P1_GLOBAL with the
// weights read from scenario 0's consts in device memory); with particles
// P1_CHAIN (the default: the weights and their transposes in shared memory)
// or P1_GLOBAL, the global-weight form (the options forms only; apg_solve.cuh,
// part_form). The P=1 wide step's forms state a minimum of one block per
// SM, as the whole solve's do (apg_solve.cu): without it ptxas held two of
// them at 128 registers; every other form keeps the bounds it had. FX (the
// wide step only): a trunk of more than P1_FMAX inputs (sweeps.cuh,
// wide_rollout).
template <bool PART, int SC, bool OPT = false, bool BF = false, int RM = RISK_IN_CLUSTER,
          int STEP = P1_CHAIN, bool FX = false>
__global__ void __launch_bounds__(PART ? ORACLE_NTHREADS_PART : ORACLE_NTHREADS,
                                  !PART && STEP != P1_CHAIN ? 1 : 0)
value_and_grad_kernel(ApgArgs a, const float* __restrict__ consts,
                      const float* __restrict__ u, const float* __restrict__ noise,
                      const float* __restrict__ starts, const float* __restrict__ moments,
                      float* __restrict__ val, float* __restrict__ grad,
                      float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float fval;
  static_assert(PART || !BF, "the P=1 value_and_grad has no bf16 trunk");
  static_assert(RM == RISK_IN_CLUSTER || RM == RISK_MOMENTS_IN, "value_and_grad reads moments");
  static_assert(RM == RISK_IN_CLUSTER || (PART && OPT), "the moments are the options forms'");
  static_assert(!PART || STEP == P1_CHAIN || (STEP == P1_GLOBAL && OPT),
                "a particle form reads its weights in shared memory or, the options form, "
                "in device memory");
  static_assert(!FX || (!PART && STEP != P1_CHAIN), "more than P1_FMAX inputs: the wide step");
  constexpr bool GW = STEP == P1_GLOBAL;
  // the particle global-weight form spreads a scenario's chunks over
  // a.groups * a.cluster blocks (sweeps.cuh, the spread note)
  constexpr bool SPREAD = PART && GW;
  Smem s = {};
  if constexpr (!PART && GW) {             // past 227 KB, the scenario's scratch region
    const bool far = vg_far(a, STEP);
    layout(a, ORACLE_VALUE_AND_GRAD, 1, false, false, &s, smem, STEP, far,
           far ? scratch + vg_scenario<false>() * (size_t)vg_far_floats(a) : nullptr);
  } else {
    layout(a, ORACLE_VALUE_AND_GRAD, 1, PART, OPT && a.risk, &s, smem, STEP);
  }
  const int tid = threadIdx.x, nt = blockDim.x;
  load_block<BF, GW>(a, s, 1, consts + vg_scen<PART, SPREAD>(a) * a.n_consts,
                     u + vg_scen<PART, SPREAD>(a) * (a.H * a.nZ));
  int rank = 0;    // the block's rank in its cluster, or among the scenario's blocks
  if constexpr (SPREAD) {
    __shared__ Spread sp;
    spread_init(a, s, &sp, scratch);
  }
  if constexpr (PART) {
    if constexpr (SPREAD) rank = spread_rank(a);
    else rank = (int)cg::this_cluster().block_rank();
    // OPT: this scenario's starts (null: x0), offset once into shared memory
    __shared__ const float* starts_p;
    if constexpr (OPT)
      if (tid == 0)
        starts_p = starts ? starts + vg_scen<true, SPREAD>(a) * ((size_t)a.P * 13) : nullptr;
    // RM: the scenario's moments where vg_part reads them
    if constexpr (RM == RISK_MOMENTS_IN)
      if (tid == 0) {
        s.red[6] = moments[2 * vg_scen<true, SPREAD>(a)];
        s.red[7] = moments[2 * vg_scen<true, SPREAD>(a) + 1];
      }
    if constexpr (GW) {
      s.wg = consts;                         // scenario 0's trunk, read in place
      __syncthreads();
    } else {
      transpose_weights(a, s);               // ends with a barrier
    }
    vg_part<SC, false, OPT, BF, RM, GW, SPREAD>(
        a, s, &fval, s.cand,
        [noise, &a] { return noise + vg_scen<true, SPREAD>(a) * ((size_t)a.H * a.P * 13); },
        [&]() -> const float* { return starts_p; });
  } else if constexpr (STEP == P1_CHAIN) {
    vg<SC>(a, s, load_p1_weights(a, s.c), &fval, s.cand);
  } else {
    wide_prep<GW>(a, s, consts);             // ends with a barrier
    vg_wide<SC, GW, false, FX>(a, s, consts, &fval, s.cand);
  }
  if (rank != 0) return;
  const int HZ = a.H * a.nZ;
  float* g_out = grad + vg_scen<PART, SPREAD>(a) * HZ;
  for (int e = tid; e < HZ; e += nt) g_out[e] = s.g[e];
  if (tid == 0) val[vg_scen<PART, SPREAD>(a)] = fval;
}

// The P=1 form of a launch of `kind` (apg_solve.cuh, p1_form): the weights
// in shared memory where one row's block (value_and_grad's 4-byte static
// cost included) fits 227 KB with them.
int p1_form_of(const ApgArgs& a, int kind) {
  return p1_form(a, [&a, kind](int step) {
    return layout(a, kind, 1, false, false, nullptr, nullptr, step) * (int)sizeof(float) +
               (kind == ORACLE_VALUE_AND_GRAD ? (int)sizeof(float) : 0) <=
           ORACLE_SMEM_LIMIT_PARTICLES;
  });
}

// The particle form of a launch of `kind` (apg_solve.cuh, part_form): the
// weights in shared memory where one block (value_and_grad's 4-byte static
// cost included) fits 227 KB with them and a's chunk.
int part_form_of(const ApgArgs& a, int kind) {
  return part_form(a, [&a, kind](int step) {
    return layout(a, kind, 1, true, a.risk != 0, nullptr, nullptr, step) * (int)sizeof(float) +
               (kind == ORACLE_VALUE_AND_GRAD ? (int)sizeof(float) : 0) <=
           ORACLE_SMEM_LIMIT_PARTICLES;
  });
}

int dyn_bytes(const ApgArgs& a, int kind, int R, bool part) {
  const int step = part ? part_form_of(a, kind) : p1_form_of(a, kind);
  const bool far = !part && kind == ORACLE_VALUE_AND_GRAD && vg_far(a, step);
  return layout(a, kind, R, part, a.risk != 0, nullptr, nullptr, step, far) *
         (int)sizeof(float);
}

// Whether a's value_and_grad launch keeps the wide step's buffers in its
// scratch (vg_far).
bool vg_far_of(const ApgArgs& a) {
  return !a.has_noise && vg_far(a, p1_form_of(a, ORACLE_VALUE_AND_GRAD));
}

// Whether a particle launch of `kind` runs the global-weight form.
bool global_weights(const ApgArgs& a, int kind) {
  return a.has_noise && part_form_of(a, kind) == P1_GLOBAL;
}

// The shared memory a block may take: 48 KB on the register chain, all
// 227 KB (dynamic, set by cost_oracle_init) with particles and on the P=1
// shared-memory step.
int smem_limit(const ApgArgs& a) {
  return a.has_noise || !p1_widths(a) ? ORACLE_SMEM_LIMIT_PARTICLES : ORACLE_SMEM_LIMIT;
}

// Candidate rows per value_batch block: one candidate per cluster with
// particles; at P=1 up to ORACLE_P1_ROWS on the register chain and
// ORACLE_TILE on the shared-memory step, fewer where wide rows would pass
// the form's budget (smem_limit).
int tile_rows(const ApgArgs& a, int K) {
  if (a.has_noise) return 1;
  const int most = p1_widths(a) ? ORACLE_P1_ROWS : ORACLE_TILE;
  int tile = K < most ? K : most;
  while (tile > 1 && dyn_bytes(a, ORACLE_VALUE_BATCH, tile, false) > smem_limit(a))
    --tile;
  return tile;
}

// batch: the scenarios of a launch (B >= 1; the grid's limits are
// grid_ok's); at P=1 the form of `kind` takes the trunk (the particle forms
// do not read it; trajectory has no particle form).
bool args_ok(const ApgArgs* a, int kind) {
  return constr_args_ok(*a) && a->OUT == 12 && a->F == 9 + a->n_u && a->H >= 1 &&
         a->batch >= 1 &&
         ((a->has_noise && kind != ORACLE_TRAJECTORY)
              ? part_form_ok(*a, part_form_of(*a, kind))
              : p1_form_ok(*a, p1_form_of(*a, kind)));
}

// One launch of a value_batch instantiation over a.batch scenarios: P=1
// ceil(K / tile) blocks on each of a.batch grid rows; particles B x K
// clusters of a.cluster blocks (cudaLaunchKernelEx, whose error a cluster
// the card cannot schedule returns), the global-weight form with a.groups >
// 1 a.groups * a.cluster blocks a plan on a cooperative grid (launch_spread
// over the B x K plans, whose error a grid the card cannot hold at once
// returns).
template <bool PART, int SC, bool REG, bool OPT = false, bool BF = false,
          int RM = RISK_IN_CLUSTER, bool GW = false>
cudaError_t launch_value_batch(const ApgArgs& a, int K, int tile, size_t dyn, cudaStream_t st,
                               const float* consts, const float* U, const float* noise,
                               const float* starts, float* out, float* scratch) {
  if constexpr (PART) {
    if constexpr (GW)
      if (a.groups > 1) {
        ApgArgs plans = a;                    // the spread's units: the B x K plans
        plans.batch = K * a.batch;
        return launch_spread(value_batch_kernel<true, SC, false, OPT, BF, RM, GW>, plans,
                             ORACLE_NTHREADS_PART, dyn, st, scratch, K, tile, a, consts, U,
                             noise, starts, out, scratch);
      }
    ClusterLaunch l(a.cluster, ORACLE_NTHREADS_PART, dyn, st, K * a.batch);
    return cudaLaunchKernelEx(&l.cfg, value_batch_kernel<true, SC, false, OPT, BF, RM, GW>, K,
                              tile, a, consts, U, noise, starts, out, scratch);
  } else {
    const dim3 grid((K + tile - 1) / tile, a.batch);
    value_batch_kernel<false, SC, REG, false, BF, RISK_IN_CLUSTER, GW>
        <<<grid, ORACLE_NTHREADS, dyn, st>>>(K, tile, a, consts, U, noise, starts, out, scratch);
    return cudaSuccess;
  }
}
using ValueBatchFn = cudaError_t (*)(const ApgArgs&, int, int, size_t, cudaStream_t,
                                     const float*, const float*, const float*, const float*,
                                     float*, float*);
#define NO3 {nullptr, nullptr, nullptr}
#if !ORACLE_GW
// [bf16][form][sc_kind]: form 0 P=1 on the shared-memory step, 1 P=1 on
// the register chain, 2 particles, 3 particles with the options, 4 their
// moments-out form, 5 P=1 on the shared-memory step with the weights in
// device memory (0, 1 and 5 in the P=1 library, 2-4 in this one)
#define MOMENTS_OUT_FORMS(BF)                                                              \
  {launch_value_batch<true, CONSTR_NONE, false, true, BF, RISK_MOMENTS_OUT>,               \
   launch_value_batch<true, CONSTR_PENALTY, false, true, BF, RISK_MOMENTS_OUT>,            \
   launch_value_batch<true, CONSTR_PROX, false, true, BF, RISK_MOMENTS_OUT>}
#define GLOBAL_WEIGHT_FORMS(BF)                                                            \
  {launch_value_batch<false, CONSTR_NONE, false, false, BF, RISK_IN_CLUSTER, true>,        \
   launch_value_batch<false, CONSTR_PENALTY, false, false, BF, RISK_IN_CLUSTER, true>,     \
   launch_value_batch<false, CONSTR_PROX, false, false, BF, RISK_IN_CLUSTER, true>}
#define VB_LAUNCH(PART, REG, OPT, BF)                                                      \
  {launch_value_batch<PART, CONSTR_NONE, REG, OPT, BF>,                                    \
   launch_value_batch<PART, CONSTR_PENALTY, REG, OPT, BF>,                                 \
   launch_value_batch<PART, CONSTR_PROX, REG, OPT, BF>}
#if ORACLE_P1
#define VB_TABLE(BF)                                                                       \
  {VB_LAUNCH(false, false, false, BF), VB_LAUNCH(false, true, false, BF), NO3, NO3, NO3,   \
   GLOBAL_WEIGHT_FORMS(BF)}
#else
#define VB_TABLE(BF)                                                                       \
  {NO3, NO3, VB_LAUNCH(true, false, false, BF), VB_LAUNCH(true, false, true, BF),          \
   MOMENTS_OUT_FORMS(BF), NO3}
#endif
const ValueBatchFn kValueBatch[2][6][3] = {VB_TABLE(false), VB_TABLE(true)};
#endif

// P=1 a.batch blocks; particles a.batch clusters of a.cluster blocks
// (cudaLaunchKernelEx, whose error a cluster the card cannot schedule
// returns), the global-weight form with a.groups > 1 a.groups * a.cluster
// blocks each on a cooperative grid (launch_spread, whose error a grid the
// card cannot hold at once returns).
template <bool PART, int SC, bool OPT = false, bool BF = false, int RM = RISK_IN_CLUSTER,
          int STEP = P1_CHAIN, bool FX = false>
cudaError_t launch_value_and_grad(const ApgArgs& a, size_t dyn, cudaStream_t st,
                                  const float* consts, const float* u, const float* noise,
                                  const float* starts, const float* moments, float* val,
                                  float* grad, float* scratch) {
  if constexpr (PART) {
    if constexpr (STEP == P1_GLOBAL)
      if (a.groups > 1)
        return launch_spread(value_and_grad_kernel<true, SC, OPT, BF, RM, STEP>, a,
                             ORACLE_NTHREADS_PART, dyn, st, scratch, a, consts, u, noise,
                             starts, moments, val, grad, scratch);
    ClusterLaunch l(a.cluster, ORACLE_NTHREADS_PART, dyn, st, a.batch);
    return cudaLaunchKernelEx(&l.cfg, value_and_grad_kernel<true, SC, OPT, BF, RM, STEP>, a,
                              consts, u, noise, starts, moments, val, grad, scratch);
  } else {
    value_and_grad_kernel<false, SC, false, false, RISK_IN_CLUSTER, STEP, FX>
        <<<a.batch, ORACLE_NTHREADS, dyn, st>>>(a, consts, u, noise, starts, moments, val,
                                                 grad, scratch);
    return cudaSuccess;
  }
}
using ValueAndGradFn = cudaError_t (*)(const ApgArgs&, size_t, cudaStream_t, const float*,
                                       const float*, const float*, const float*, const float*,
                                       float*, float*, float*);
using VbKernel = void (*)(int, int, ApgArgs, const float*, const float*, const float*,
                          const float*, float*, float*);
using VgKernel = void (*)(ApgArgs, const float*, const float*, const float*, const float*,
                          const float*, float*, float*, float*);
#if ORACLE_P1
// The P=1 kernels, whose shared memory may pass 48 KB off the register
// chain: value_batch [bf16][global weights][sc_kind], value_and_grad [global
// weights][sc_kind] and its forms over more than P1_FMAX inputs, trajectory
// [global weights] (cost_oracle_init).
#define P1_VB(BF, GW)                                                                      \
  {value_batch_kernel<false, CONSTR_NONE, false, false, BF, RISK_IN_CLUSTER, GW>,          \
   value_batch_kernel<false, CONSTR_PENALTY, false, false, BF, RISK_IN_CLUSTER, GW>,       \
   value_batch_kernel<false, CONSTR_PROX, false, false, BF, RISK_IN_CLUSTER, GW>}
#define P1_VG(STEP, FX)                                                                    \
  {value_and_grad_kernel<false, CONSTR_NONE, false, false, RISK_IN_CLUSTER, STEP, FX>,     \
   value_and_grad_kernel<false, CONSTR_PENALTY, false, false, RISK_IN_CLUSTER, STEP, FX>,  \
   value_and_grad_kernel<false, CONSTR_PROX, false, false, RISK_IN_CLUSTER, STEP, FX>}
const VbKernel kP1Vb[2][2][3] = {{P1_VB(false, false), P1_VB(false, true)},
                                  {P1_VB(true, false), P1_VB(true, true)}};
const VgKernel kP1Vg[2][2][3] = {{P1_VG(P1_SMEM, false), P1_VG(P1_GLOBAL, false)},
                                  {P1_VG(P1_SMEM, true), P1_VG(P1_GLOBAL, true)}};
#endif
#if !ORACLE_GW
// [form][sc_kind]: form 0 P=1 on the register chain, 1 particles, 2
// particles with the options, 3 and 4 the bf16 trunk of 1 and 2, 5 and 6
// the moments-in form of 2 and 4, 7 P=1 on the wide step, 8 on it with the
// weights in device memory, 9 and 10 the two over more than P1_FMAX inputs
// (0 and 7-10 in the P=1 library, 1-6 in this one)
#define MOMENTS_IN_FORMS(BF)                                                               \
  {launch_value_and_grad<true, CONSTR_NONE, true, BF, RISK_MOMENTS_IN>,                    \
   launch_value_and_grad<true, CONSTR_PENALTY, true, BF, RISK_MOMENTS_IN>,                 \
   launch_value_and_grad<true, CONSTR_PROX, true, BF, RISK_MOMENTS_IN>}
#define P1_STEP_VG(STEP, FX)                                                               \
  {launch_value_and_grad<false, CONSTR_NONE, false, false, RISK_IN_CLUSTER, STEP, FX>,     \
   launch_value_and_grad<false, CONSTR_PENALTY, false, false, RISK_IN_CLUSTER, STEP, FX>,  \
   launch_value_and_grad<false, CONSTR_PROX, false, false, RISK_IN_CLUSTER, STEP, FX>}
#define VG_LAUNCH(PART, OPT, BF)                                                           \
  {launch_value_and_grad<PART, CONSTR_NONE, OPT, BF>,                                      \
   launch_value_and_grad<PART, CONSTR_PENALTY, OPT, BF>,                                   \
   launch_value_and_grad<PART, CONSTR_PROX, OPT, BF>}
const ValueAndGradFn kValueAndGrad[11][3] = {
#if ORACLE_P1
    VG_LAUNCH(false, false, false), NO3, NO3, NO3, NO3, NO3, NO3,
    P1_STEP_VG(P1_SMEM, false), P1_STEP_VG(P1_GLOBAL, false),
    P1_STEP_VG(P1_SMEM, true), P1_STEP_VG(P1_GLOBAL, true)};
#else
    NO3, VG_LAUNCH(true, false, false), VG_LAUNCH(true, true, false),
    VG_LAUNCH(true, false, true), VG_LAUNCH(true, true, true),
    MOMENTS_IN_FORMS(false), MOMENTS_IN_FORMS(true), NO3, NO3, NO3, NO3};
#endif
#endif

#if !ORACLE_GW && !ORACLE_P1
// The particle forms' kernels [bf16][opt][sc_kind] of value_batch and
// value_and_grad: opt 0 without the options, 1 with them, 2 their
// shared-moments form (value_batch's moments out, value_and_grad's moments
// in).
#define VB_MOMENTS(BF)                                                                     \
  {value_batch_kernel<true, CONSTR_NONE, false, true, BF, RISK_MOMENTS_OUT>,               \
   value_batch_kernel<true, CONSTR_PENALTY, false, true, BF, RISK_MOMENTS_OUT>,            \
   value_batch_kernel<true, CONSTR_PROX, false, true, BF, RISK_MOMENTS_OUT>}
#define VG_MOMENTS(BF)                                                                     \
  {value_and_grad_kernel<true, CONSTR_NONE, true, BF, RISK_MOMENTS_IN>,                    \
   value_and_grad_kernel<true, CONSTR_PENALTY, true, BF, RISK_MOMENTS_IN>,                 \
   value_and_grad_kernel<true, CONSTR_PROX, true, BF, RISK_MOMENTS_IN>}
const VbKernel kVbForms[2][3][3] = {
    {{value_batch_kernel<true, CONSTR_NONE, false, false, false>,
      value_batch_kernel<true, CONSTR_PENALTY, false, false, false>,
      value_batch_kernel<true, CONSTR_PROX, false, false, false>},
     {value_batch_kernel<true, CONSTR_NONE, false, true, false>,
      value_batch_kernel<true, CONSTR_PENALTY, false, true, false>,
      value_batch_kernel<true, CONSTR_PROX, false, true, false>},
     VB_MOMENTS(false)},
    {{value_batch_kernel<true, CONSTR_NONE, false, false, true>,
      value_batch_kernel<true, CONSTR_PENALTY, false, false, true>,
      value_batch_kernel<true, CONSTR_PROX, false, false, true>},
     {value_batch_kernel<true, CONSTR_NONE, false, true, true>,
      value_batch_kernel<true, CONSTR_PENALTY, false, true, true>,
      value_batch_kernel<true, CONSTR_PROX, false, true, true>},
     VB_MOMENTS(true)}};
const VgKernel kVgForms[2][3][3] = {
    {{value_and_grad_kernel<true, CONSTR_NONE, false, false>,
      value_and_grad_kernel<true, CONSTR_PENALTY, false, false>,
      value_and_grad_kernel<true, CONSTR_PROX, false, false>},
     {value_and_grad_kernel<true, CONSTR_NONE, true, false>,
      value_and_grad_kernel<true, CONSTR_PENALTY, true, false>,
      value_and_grad_kernel<true, CONSTR_PROX, true, false>},
     VG_MOMENTS(false)},
    {{value_and_grad_kernel<true, CONSTR_NONE, false, true>,
      value_and_grad_kernel<true, CONSTR_PENALTY, false, true>,
      value_and_grad_kernel<true, CONSTR_PROX, false, true>},
     {value_and_grad_kernel<true, CONSTR_NONE, true, true>,
      value_and_grad_kernel<true, CONSTR_PENALTY, true, true>,
      value_and_grad_kernel<true, CONSTR_PROX, true, true>},
     VG_MOMENTS(true)}};
#elif ORACLE_GW
// The global-weight forms [bf16][moments][sc_kind], kernels and launchers:
// the options forms of value_batch and value_and_grad (moments 0; a launch
// without risk or starts takes them too, their branches off) and their
// shared-moments forms (moments 1: value_batch's moments out,
// value_and_grad's moments in).
#define GW_VB(BF, RM)                                                                      \
  {value_batch_kernel<true, CONSTR_NONE, false, true, BF, RM, true>,                       \
   value_batch_kernel<true, CONSTR_PENALTY, false, true, BF, RM, true>,                    \
   value_batch_kernel<true, CONSTR_PROX, false, true, BF, RM, true>}
#define GW_VG(BF, RM)                                                                      \
  {value_and_grad_kernel<true, CONSTR_NONE, true, BF, RM, P1_GLOBAL>,                      \
   value_and_grad_kernel<true, CONSTR_PENALTY, true, BF, RM, P1_GLOBAL>,                   \
   value_and_grad_kernel<true, CONSTR_PROX, true, BF, RM, P1_GLOBAL>}
#define GW_VB_LAUNCH(BF, RM)                                                               \
  {launch_value_batch<true, CONSTR_NONE, false, true, BF, RM, true>,                       \
   launch_value_batch<true, CONSTR_PENALTY, false, true, BF, RM, true>,                    \
   launch_value_batch<true, CONSTR_PROX, false, true, BF, RM, true>}
#define GW_VG_LAUNCH(BF, RM)                                                               \
  {launch_value_and_grad<true, CONSTR_NONE, true, BF, RM, P1_GLOBAL>,                      \
   launch_value_and_grad<true, CONSTR_PENALTY, true, BF, RM, P1_GLOBAL>,                   \
   launch_value_and_grad<true, CONSTR_PROX, true, BF, RM, P1_GLOBAL>}
const VbKernel kVbGW[2][2][3] = {
    {GW_VB(false, RISK_IN_CLUSTER), GW_VB(false, RISK_MOMENTS_OUT)},
    {GW_VB(true, RISK_IN_CLUSTER), GW_VB(true, RISK_MOMENTS_OUT)}};
const VgKernel kVgGW[2][2][3] = {
    {GW_VG(false, RISK_IN_CLUSTER), GW_VG(false, RISK_MOMENTS_IN)},
    {GW_VG(true, RISK_IN_CLUSTER), GW_VG(true, RISK_MOMENTS_IN)}};
const ValueBatchFn kVbGWLaunch[2][2][3] = {
    {GW_VB_LAUNCH(false, RISK_IN_CLUSTER), GW_VB_LAUNCH(false, RISK_MOMENTS_OUT)},
    {GW_VB_LAUNCH(true, RISK_IN_CLUSTER), GW_VB_LAUNCH(true, RISK_MOMENTS_OUT)}};
const ValueAndGradFn kVgGWLaunch[2][2][3] = {
    {GW_VG_LAUNCH(false, RISK_IN_CLUSTER), GW_VG_LAUNCH(false, RISK_MOMENTS_IN)},
    {GW_VG_LAUNCH(true, RISK_IN_CLUSTER), GW_VG_LAUNCH(true, RISK_MOMENTS_IN)}};
#endif

// The particle fields, the noise block and the particle options (risk and
// starts: particles only), when the kernel reads them.
bool particles_ok(const ApgArgs* a, const void* noise, const void* starts) {
  if ((a->has_starts != 0) != (starts != nullptr)) return false;
  if (!a->has_noise)
    return a->P == 1 && a->Pc == 1 && a->n_chunks == 1 && !options(*a);
  return noise != nullptr && a->Pc >= 1 && a->n_chunks >= 1 &&
         a->Pc * a->n_chunks == a->P;
}

// The form of a particle launch of `kind` (ORACLE_VALUE_BATCH,
// ORACLE_VALUE_AND_GRAD) by its options (kVbForms' `opt`): 0 without them,
// 1 with them, 2 their shared-moments form (a.risk_mode; risk only); -1 for
// a risk mode the kernel does not take (value_batch writes the moments out,
// value_and_grad reads them in).
int opt_form(const ApgArgs* a, int kind) {
  if (a->risk_mode == RISK_IN_CLUSTER) return options(*a) ? 1 : 0;
  const int mode = kind == ORACLE_VALUE_BATCH ? RISK_MOMENTS_OUT : RISK_MOMENTS_IN;
  return a->risk_mode == mode && a->has_noise && a->risk ? 2 : -1;
}

// The largest cluster of each particle form [kind][bf16][opt][sc_kind],
// value_batch and value_and_grad, without and with the options (and their
// shared-moments forms) and the bf16 trunk (cost_oracle_init; 0 before it);
// in the global-weight library its options form's under opt 0 and 1.
int g_cmax[3][2][3][3] = {};

// This library's kernel and launcher of a particle launch of `kind` (opt:
// opt_form), or null where the form is the other library's.
VbKernel vb_kernel(const ApgArgs& a, int opt) {
#if ORACLE_GW
  return global_weights(a, ORACLE_VALUE_BATCH) ? kVbGW[a.bf16 != 0][opt == 2][a.sc_kind]
                                               : nullptr;
#elif ORACLE_P1
  (void)a, (void)opt;
  return nullptr;
#else
  return global_weights(a, ORACLE_VALUE_BATCH) ? nullptr
                                               : kVbForms[a.bf16 != 0][opt][a.sc_kind];
#endif
}
VgKernel vg_kernel(const ApgArgs& a, int opt) {
#if ORACLE_GW
  return global_weights(a, ORACLE_VALUE_AND_GRAD) ? kVgGW[a.bf16 != 0][opt == 2][a.sc_kind]
                                                  : nullptr;
#elif ORACLE_P1
  (void)a, (void)opt;
  return nullptr;
#else
  return global_weights(a, ORACLE_VALUE_AND_GRAD) ? nullptr
                                                  : kVgForms[a.bf16 != 0][opt][a.sc_kind];
#endif
}

// This library's value_batch launcher for a launch (P=1 or particles), or
// null where its form is the other library's.
ValueBatchFn vb_launcher(const ApgArgs& a, int opt) {
  const bool gw = global_weights(a, ORACLE_VALUE_BATCH);
#if ORACLE_GW
  return gw ? kVbGWLaunch[a.bf16 != 0][opt == 2][a.sc_kind] : nullptr;
#else
  if (gw) return nullptr;
  const int step = p1_form_of(a, ORACLE_VALUE_BATCH);
  const int form = a.has_noise ? 2 + opt : step == P1_CHAIN ? 1 : step == P1_GLOBAL ? 5 : 0;
  return kValueBatch[a.bf16 != 0][form][a.sc_kind];
#endif
}

// ... and its value_and_grad launcher.
ValueAndGradFn vg_launcher(const ApgArgs& a, int opt) {
  const bool gw = global_weights(a, ORACLE_VALUE_AND_GRAD);
#if ORACLE_GW
  return gw ? kVgGWLaunch[a.bf16 != 0][opt == 2][a.sc_kind] : nullptr;
#else
  if (gw) return nullptr;
  const int step = a.has_noise ? P1_CHAIN : p1_form_of(a, ORACLE_VALUE_AND_GRAD);
  const int fx = a.F > P1_FMAX ? 2 : 0;      // more inputs than the registers of 7 and 8
  const int form = !a.has_noise ? (step == P1_CHAIN ? 0 : (step == P1_SMEM ? 7 : 8) + fx)
                   : opt == 2 ? 5 + (a.bf16 ? 1 : 0)
                              : (opt ? 2 : 1) + (a.bf16 ? 2 : 0);
  return kValueAndGrad[form][a.sc_kind];
#endif
}

bool sc_ok(int sc_kind) { return sc_kind >= CONSTR_NONE && sc_kind <= CONSTR_PROX; }

// Whether the grid of a launch over a.batch scenarios (K plans each for
// value_batch) fits the card's limits: the P=1 value_batch's rows on the y
// dimension (65535), every other grid's blocks on x (2^31 - 1).
bool grid_ok(const ApgArgs* a, int kind, int K = 1) {
  if (kind == ORACLE_VALUE_BATCH && !a->has_noise) return a->batch <= 65535;
  const long long per = kind == ORACLE_TRAJECTORY ? 1
                        : a->has_noise ? (long long)a->cluster * a->groups * K : 1;
  return (long long)a->batch * per <= 2147483647LL;
}

}  // namespace

extern "C" {

int cost_oracle_args_size() { return (int)sizeof(ApgArgs); }

const char* cost_oracle_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Let the particle forms and the P=1 shared-memory step take dynamic shared
// memory above 48 KB (the register chain stays inside the default) and find
// each particle form's largest cluster (sweeps.cuh::cluster_max). Called
// once when the library is loaded; returns a cudaError_t.
int cost_oracle_init() {
#if ORACLE_GW
  for (int bf = 0; bf < 2; ++bf)
    for (int m = 0; m < 2; ++m)
      for (int sc = CONSTR_NONE; sc <= CONSTR_PROX; ++sc) {
        const VbKernel vb = kVbGW[bf][m][sc];
        const VgKernel vg = kVgGW[bf][m][sc];
        const int o = m ? 2 : 1;             // opt_form: the options form, its moments form
        cudaError_t e = allow_large_smem(vb);
        if (e == cudaSuccess) e = allow_large_smem(vg);
        if (e == cudaSuccess)
          e = cluster_max(vb, ORACLE_NTHREADS_PART, &g_cmax[ORACLE_VALUE_BATCH][bf][o][sc]);
        if (e == cudaSuccess)
          e = cluster_max(vg, ORACLE_NTHREADS_PART, &g_cmax[ORACLE_VALUE_AND_GRAD][bf][o][sc]);
        if (e != cudaSuccess) return (int)e;
        if (!m) {                             // a launch without the options: the same form
          g_cmax[ORACLE_VALUE_BATCH][bf][0][sc] = g_cmax[ORACLE_VALUE_BATCH][bf][1][sc];
          g_cmax[ORACLE_VALUE_AND_GRAD][bf][0][sc] = g_cmax[ORACLE_VALUE_AND_GRAD][bf][1][sc];
        }
      }
  return 0;
#elif ORACLE_P1
  for (int gw = 0; gw < 2; ++gw) {
    for (int sc = CONSTR_NONE; sc <= CONSTR_PROX; ++sc) {
      cudaError_t e = allow_large_smem(kP1Vb[0][gw][sc]);
      if (e == cudaSuccess) e = allow_large_smem(kP1Vb[1][gw][sc]);
      if (e == cudaSuccess) e = allow_large_smem(kP1Vg[0][gw][sc]);
      if (e == cudaSuccess) e = allow_large_smem(kP1Vg[1][gw][sc]);
      if (e != cudaSuccess) return (int)e;
    }
    const cudaError_t e = gw ? allow_large_smem(trajectory_kernel<false, true>)
                             : allow_large_smem(trajectory_kernel<false, false>);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
#else
  for (int bf = 0; bf < 2; ++bf)
    for (int o = 0; o < 3; ++o)
      for (int sc = CONSTR_NONE; sc <= CONSTR_PROX; ++sc) {
        const VbKernel vb = kVbForms[bf][o][sc];
        const VgKernel vg = kVgForms[bf][o][sc];
        cudaError_t e = allow_large_smem(vb);
        if (e == cudaSuccess) e = allow_large_smem(vg);
        if (e == cudaSuccess)
          e = cluster_max(vb, ORACLE_NTHREADS_PART, &g_cmax[ORACLE_VALUE_BATCH][bf][o][sc]);
        if (e == cudaSuccess)
          e = cluster_max(vg, ORACLE_NTHREADS_PART, &g_cmax[ORACLE_VALUE_AND_GRAD][bf][o][sc]);
        if (e != cudaSuccess) return (int)e;
      }
  return 0;
#endif
}

// The largest cluster of the particle form of `kind` (ORACLE_VALUE_BATCH,
// ORACLE_VALUE_AND_GRAD), sc_kind, opt (0 without the options, 1 the
// options' form, 2 its shared-moments form) and bf16 (the bf16 trunk's); 0
// for other kinds.
int oracle_cluster_max(int kind, int sc_kind, int opt, int bf16) {
  return (kind == ORACLE_VALUE_BATCH || kind == ORACLE_VALUE_AND_GRAD) && sc_ok(sc_kind) &&
                 opt >= 0 && opt <= 2
             ? g_cmax[kind][bf16 != 0][opt][sc_kind] : 0;
}

// How many blocks of value_and_grad's global-weight form for a's
// dimensions, chunk and precision the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), into *n:
// the bound on a spread launch's batch * groups * cluster
// (ops/cuda/consts.py::plan_groups); returns a cudaError_t.
int oracle_resident_blocks(const ApgArgs* a, int* n) {
  const int o = opt_form(a, ORACLE_VALUE_AND_GRAD);
  if (!a->has_noise || !sc_ok(a->sc_kind) || o < 0 ||
      part_form_of(*a, ORACLE_VALUE_AND_GRAD) != P1_GLOBAL)
    return (int)cudaErrorInvalidValue;
  const VgKernel fn = vg_kernel(*a, o);
  return fn ? (int)resident_blocks(fn, ORACLE_NTHREADS_PART,
                                   (size_t)dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1, true), n)
            : (int)cudaErrorInvalidValue;     // the other library's form
}

// ... and of value_batch's global-weight form (one plan a block's chunks;
// the bound on a spread launch's batch * K * groups * cluster).
int value_batch_resident_blocks(const ApgArgs* a, int* n) {
  const int o = opt_form(a, ORACLE_VALUE_BATCH);
  if (!a->has_noise || !sc_ok(a->sc_kind) || o < 0 ||
      part_form_of(*a, ORACLE_VALUE_BATCH) != P1_GLOBAL)
    return (int)cudaErrorInvalidValue;
  const VbKernel fn = vb_kernel(*a, o);
  return fn ? (int)resident_blocks(fn, ORACLE_NTHREADS_PART,
                                   (size_t)dyn_bytes(*a, ORACLE_VALUE_BATCH, 1, true), n)
            : (int)cudaErrorInvalidValue;     // the other library's form
}

// Floats of the scratch a particle value_batch launch over K plans a
// scenario with a's plan takes: apg_solve.cuh's spread_floats over the
// a.batch * K plans, each a spread unit of its own (0 but for the
// global-weight form at groups > 1).
long long value_batch_scratch_floats(const ApgArgs* a, int K) {
  if (!a->has_noise || K < 1) return 0;
  ApgArgs plans = *a;
  plans.batch = a->batch * K;
  return spread_floats(plans);
}

// Floats of the scratch a value_and_grad launch with a's plan takes: with
// particles apg_solve.cuh's spread_floats (0 but for the global-weight form
// at groups > 1), at P=1 a region a scenario where the wide step keeps its
// width-sized buffers in device memory (vg_far), else 0.
long long value_and_grad_scratch_floats(const ApgArgs* a) {
  if (a->has_noise) return spread_floats(*a);
  return vg_far_of(*a) ? (long long)a->batch * vg_far_floats(*a) : 0;
}

// cudaOccupancyMaxActiveClusters of the particle form of `kind` for a's
// dimensions, cluster size and precision, into *n; returns a cudaError_t.
int oracle_max_active_clusters(int kind, const ApgArgs* a, int* n) {
  if (!a->has_noise || !sc_ok(a->sc_kind) || a->cluster < 1 ||
      (kind != ORACLE_VALUE_BATCH && kind != ORACLE_VALUE_AND_GRAD) || opt_form(a, kind) < 0)
    return (int)cudaErrorInvalidValue;
  const size_t dyn = (size_t)dyn_bytes(*a, kind, 1, true);
  const int o = opt_form(a, kind);
  if (kind == ORACLE_VALUE_BATCH) {
    const VbKernel fn = vb_kernel(*a, o);
    return fn ? (int)max_active_clusters(fn, a->cluster, ORACLE_NTHREADS_PART, dyn, n)
              : (int)cudaErrorInvalidValue;     // the other library's form
  }
  const VgKernel fn = vg_kernel(*a, o);
  return fn ? (int)max_active_clusters(fn, a->cluster, ORACLE_NTHREADS_PART, dyn, n)
            : (int)cudaErrorInvalidValue;
}

// Shared memory one block of each kernel needs (dynamic + static).
int value_batch_smem_bytes(const ApgArgs* a, int K) {
  return dyn_bytes(*a, ORACLE_VALUE_BATCH, tile_rows(*a, K), a->has_noise != 0);
}
int trajectory_smem_bytes(const ApgArgs* a) {
  return dyn_bytes(*a, ORACLE_TRAJECTORY, 1, false);
}
int value_and_grad_smem_bytes(const ApgArgs* a) {
  return dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1, a->has_noise != 0) + (int)sizeof(float);
}

// Candidate rows per block of a value_batch launch over K plans (1 with
// particles: one candidate per cluster).
int value_batch_rows(const ApgArgs* a, int K) { return tile_rows(*a, K); }

// The P=1 form (P1_*) a launch of `kind` with a's dimensions runs
// (p1_form_of).
int oracle_p1_form(const ApgArgs* a, int kind) { return p1_form_of(*a, kind); }

// The particle form (P1_SMEM, P1_GLOBAL) a launch of `kind`
// (ORACLE_VALUE_BATCH, ORACLE_VALUE_AND_GRAD) with a's dimensions and chunk
// runs (part_form_of).
int oracle_part_form(const ApgArgs* a, int kind) { return part_form_of(*a, kind); }

// Launchers: one launch on `stream` each over a->batch scenarios B,
// returning the launch's error (cudaErrorInvalidValue for arguments the
// kernels do not take). consts is (B, n_consts), U (B, K, H, nZ), u
// (B, H, nZ), noise the (B, H, P, 13) Brownian blocks (read only when
// a->has_noise; may be null otherwise), starts the (B, P, 13) particles'
// initial states or null (particles only, with a->has_starts; with it or
// a->risk the options' form runs); outputs are (B, K), (B, H+1, 13),
// (B,) and (B, H, nZ). A risk launch with a->risk_mode RISK_MOMENTS_OUT
// (value_batch) writes (B, K, 3) triples (the risk-free cost, the mean of
// the totals, their centred second moment); with RISK_MOMENTS_IN
// (value_and_grad) it reads `moments` (B, 2), each scenario's mean and std
// of the totals (null otherwise), and writes the risk-free cost of its
// particles to val. A P=1 launch runs the form p1_form_of picks (or
// a->step names), which the trunk's widths and the form's shared memory
// must take; the
// particle forms a's cluster plan of its chunks (value_batch one cluster
// per candidate), and return the cluster launch's own error where the card
// cannot schedule it.
int value_batch_launch(const ApgArgs* a, int K, const void* consts, const void* U,
                       const void* noise, const void* starts, void* out, void* scratch,
                       void* stream) {
  const int opt = opt_form(a, ORACLE_VALUE_BATCH);
  if (!args_ok(a, ORACLE_VALUE_BATCH) || K < 1 || !grid_ok(a, ORACLE_VALUE_BATCH, K) ||
      !particles_ok(a, noise, starts) || opt < 0 ||
      (a->has_noise && !cluster_args_ok(
          *a, g_cmax[ORACLE_VALUE_BATCH][a->bf16 != 0][opt][a->sc_kind],
          global_weights(*a, ORACLE_VALUE_BATCH))) ||
      (!a->has_noise && a->groups != 1) ||
      (value_batch_scratch_floats(a, K) > 0 && scratch == nullptr) ||
      value_batch_smem_bytes(a, K) > smem_limit(*a))
    return (int)cudaErrorInvalidValue;
  const ValueBatchFn fn = vb_launcher(*a, opt);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;    // the other library's form
  return launch_error(fn(
      *a, K, tile_rows(*a, K), (size_t)value_batch_smem_bytes(a, K), (cudaStream_t)stream,
      (const float*)consts, (const float*)U, (const float*)noise, (const float*)starts,
      (float*)out, (float*)scratch));
}

int trajectory_launch(const ApgArgs* a, const void* consts, const void* u,
                      void* x_out, void* stream) {
#if !ORACLE_P1
  return (int)cudaErrorInvalidValue;       // trajectory is the P=1 library's
#else
  // (x_evol of a particle solve too: the mean dynamics, on a P=1 form)
  const int step = p1_form_of(*a, ORACLE_TRAJECTORY);
  if (!args_ok(a, ORACLE_TRAJECTORY) || !grid_ok(a, ORACLE_TRAJECTORY) ||
      trajectory_smem_bytes(a) > (step == P1_CHAIN ? ORACLE_SMEM_LIMIT
                                                   : ORACLE_SMEM_LIMIT_PARTICLES))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = (size_t)trajectory_smem_bytes(a);
  const cudaStream_t st = (cudaStream_t)stream;
  if (step == P1_CHAIN)
    trajectory_kernel<true><<<a->batch, ORACLE_NTHREADS, dyn, st>>>(
        *a, (const float*)consts, (const float*)u, (float*)x_out);
  else if (step == P1_SMEM)
    trajectory_kernel<false><<<a->batch, ORACLE_NTHREADS, dyn, st>>>(
        *a, (const float*)consts, (const float*)u, (float*)x_out);
  else
    trajectory_kernel<false, true><<<a->batch, ORACLE_NTHREADS, dyn, st>>>(
        *a, (const float*)consts, (const float*)u, (float*)x_out);
  return (int)cudaGetLastError();
#endif
}

int value_and_grad_launch(const ApgArgs* a, const void* consts, const void* u,
                          const void* noise, const void* starts, const void* moments,
                          void* val, void* grad, void* scratch, void* stream) {
  const int opt = opt_form(a, ORACLE_VALUE_AND_GRAD);
  if (!args_ok(a, ORACLE_VALUE_AND_GRAD) || !grid_ok(a, ORACLE_VALUE_AND_GRAD) ||
      !particles_ok(a, noise, starts) ||
      opt < 0 || (opt == 2) != (moments != nullptr) ||
      (!a->has_noise && (a->bf16 || a->groups != 1)) ||
      (vg_far_of(*a) && scratch == nullptr) ||
      (a->has_noise && !cluster_args_ok(
          *a, g_cmax[ORACLE_VALUE_AND_GRAD][a->bf16 != 0][opt][a->sc_kind],
          global_weights(*a, ORACLE_VALUE_AND_GRAD))) ||
      value_and_grad_smem_bytes(a) > smem_limit(*a))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1, a->has_noise != 0);
  const ValueAndGradFn fn = vg_launcher(*a, opt);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;    // the other library's form
  return launch_error(fn(
      *a, dyn, (cudaStream_t)stream, (const float*)consts, (const float*)u,
      (const float*)noise, (const float*)starts, (const float*)moments, (float*)val,
      (float*)grad, (float*)scratch));
}

}  // extern "C"
