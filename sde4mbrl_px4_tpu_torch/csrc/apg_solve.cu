// Whole-solve APG kernel for Hopper (sm_90a): one receding-horizon MPC
// solve per thread block (P=1) or thread-block cluster (particles), for
// a.batch independent scenarios per launch.
//
// Replaces the TPU kernel sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py::
// pallas_apg_solve (pallas_call at :420, body _kernel :163-391) together
// with the sde4mbrl_px4_tpu/ops/pallas/bodies.py functions it runs:
// make_step with want_acts and with its Brownian term (K1),
// manual_bwd_step/_qrotate_bwd (K2), vg_sweep on its flight branch and on
// its noise branch with the chunk loop (K3, K11), candidate_rollout/
// run_candidates over P particles in chunks (K4, K11), the control cost
// inlined at apg_kernel.py:239-262 (K5), and the build_consts layout (K7,
// ops/cuda/consts.py), with make_step's state-constraint branch
// (bodies.py:188-206) and its reverse, which the TPU kernel traces with
// jax.vjp (apg_kernel.py:140-142), and the widened decision row nZ = n_u + m
// of the proximal form (apg_kernel.py:240-266).
//
// Six instantiations of one kernel body, apg_solve_kernel<PART, SC>:
//   PART = false  deterministic P=1 (the flight configs): the mean
//                 dynamics, the manual reverse sweep on the activation
//                 stash, x_evol from the exit sweep;
//   PART = true   Monte-Carlo particles (has_noise): P paths in n_chunks
//                 passes of Pc rows, the Brownian block (H, P, 13) read
//                 from device memory per step, the reverse sweep re-running
//                 the trunk from the stashed states (vg_part), the K
//                 candidates as K*Pc rows per pass (cand_part); x_evol is
//                 the trajectory kernel's (cost_oracle.cu);
//   SC            the state_constr form (CONSTR_NONE, CONSTR_PENALTY,
//                 CONSTR_PROX; sweeps.cuh::constr_cost/constr_bwd): the
//                 constraint terms in every stage cost and their cotangents
//                 in every reverse step. In the proximal form the candidate
//                 clip, the Armijo <g, d> and <d, D^-1 d> and the iterate
//                 update run over the nZ columns, the control terms over the
//                 first n_u. CONSTR_NONE compiles to the code the kernel had
//                 before the constraint forms existed;
// and three more of the particle form with the particle options (OPT,
// below), plus the clock-stamped two; and the P=1 form on the wide step
// (STEP, below; six and one clock-stamped, in apg_solve_p1.cu's library, and
// six more over trunks of more than P1_FMAX inputs, FX, in
// apg_solve_p1x.cu's). The libraries
// (APG_CHAIN_LIB and below) split the forms so that nvcc builds them in
// parallel: the P=1 register chain in apg_solve_chain.cu, the fp32
// particle forms here.
//
// What bounds it on this card: latency, not FLOPs or bytes. At P=1 one APG
// iteration is about 1.6 MFLOP (a forward and a reverse sweep of one row
// plus a forward sweep of K candidate rows, each step a (9+n_u)->64->64->12
// MLP), serial over the H steps of the horizon and over up to max_iter
// iterations; the whole working set is ~45 KB. At P=512 and K=4 an
// iteration is ~0.9 GFLOP (2,048 candidate rows, 512 forward and 512
// reverse rows, the reverse re-running the trunk), spread over the SMs of
// a cluster, one chunk of Pc rows at a time on each. What the design does
// about it: everything (consts, iterates, the state stash, a chunk's rows)
// lives in shared memory for the whole solve, so the loop touches device
// memory only for the noise rows (L2-resident, 532 KB at P=512), the K
// linesearch candidates are rows of one batched rollout, and the loop exits
// on the device. No allocation, no host round trip, one launch per solve.
//
// The P=1 forms shorten the serial chain of a step (sweeps.cuh, p1_rollout
// / p1_reverse): the trunk weights sit in registers for the whole solve;
// the 64x64 layer runs split-K over all 256 threads (4 per hidden unit, two
// xor shuffles); layers 0 and 2 and the row's Euler step run in the 32
// lanes of the row's warp, alike in every lane, so the new state never
// leaves registers; two block barriers per forward and per reverse step
// (candidate row k is warp k, K <= APG_MAXK = 8 warps). Their register
// layout fixes HID = 64 and F <= 16. Every other trunk runs the P=1 wide
// step (P1_SMEM, the template's STEP; sweeps.cuh, vg_wide / cand_wide; the
// TPU kernel takes any width): the chain's structure over a runtime width,
// the row's scalar step and layers 0 and 2 in its warp, layer 1 and its
// transpose split over the block's eight warps (each a slice of the inputs,
// or 16 hidden units, HID/32 a lane), two block barriers a step each way,
// the vg row and the K candidates one rollout's rows (a row's sums do not
// depend on the rows beside it, so the Armijo test stays exact); the
// weights stay in the block's consts copy while the layout fits 227 KB
// (dynamic shared memory, set by apg_init), and past that (P1_GLOBAL)
// they are read from device memory (scenario 0's; L2-resident, 290 KB at
// 256 units) and only the consts before them are copied; past 227 KB
// again (wide_far: 624 units on the iris traj config) the step's
// width-sized buffers go to the launch's scratch in device memory, so the
// form takes any width to 2048 units and past. The step holds a row's
// features, controls and wrench in registers, P1_FMAX of them; a trunk of
// more inputs (9 + n_u > 16: eight motors or more) runs the forms FX, whose
// layer 0 reads the inputs past P1_FMAX from the row's controls in shared
// memory and whose reverse sums layer 0's transpose P1_FMAX inputs at a
// time, a library of their own (apg_solve_p1x.cu), so that the forms of up
// to 16 inputs keep their code. The launcher
// picks the form from the dimensions (p1_form_of); these forms are a
// library of their own (apg_solve_p1.cu), built in parallel. The
// particle form keeps the generic shared-memory trunk: it takes dynamic
// shared memory above 48 KB (up to 227 KB, set once per library load by
// apg_init), which sets the chunk: the wrapper takes the largest divisor Pc
// of P whose layout fits (Pc = 32 at P=512, K=4, iris widths). Its chunks
// run on a thread-block cluster, one block per SM (the 227 KB block fills
// its SM): C = min(n_chunks, 16 or 8) blocks, block `rank` sweeping chunks
// rank, rank + C, ..., each keeping its chunks' partials (the gradient
// share, the vg costs, the K candidates' means) apart in its shared memory;
// after each sweep every block sums all chunks' partials in chunk order
// through distributed shared memory (sweeps.cuh, cluster_chunk_sum), so
// every C gives the bits of C = 1 and every block holds the same gradient
// and costs. The loop then runs alike in every block of the cluster: the
// trial step, the candidates, the Armijo accept, the momentum and the stops
// on identical data, so every block leaves the loop on the same iteration;
// rank 0 writes the outputs. Two reductions per iteration, each between two
// cluster barriers. The candidate rows' step (K*Pc rows, the largest)
// computes the trunk's products as register tiles (sweeps.cuh::rows_gemm: a
// thread holds up to 4 rows x 4 units of sums, so each shared-memory load
// feeds up to 4 products), with the sums in the order of a thread per
// output. The vg sweep keeps a thread per output: its tiled form moved the
// last bits of some gradients on the P=512 route, and with them the chained
// solves' iteration counts. The constraint terms add per-row scalar
// arithmetic to each step's serial chain and no memory traffic (their
// constants sit in shared memory with the rest); the proximal form's wider
// rows (nZ = 10 on the shipped iris config) take the P=1 layout past the
// 48 KB default, so the constrained P=1 forms take dynamic shared memory
// above it too (set once per library load by apg_init).
//
// Trunks past the particle form's shared memory (apg_solve.cuh, part_form;
// past 144 units at P=512 on the iris configs, whose trunk and transposes
// take 196 KB of the block's 227 KB): the global-weight form apg_solve_kernel<
// true, SC, false, true, BF, P1_GLOBAL> reads the weights in place from
// scenario 0's consts in device memory (sweeps.cuh, GW; 290 KB at 256 units,
// L2-resident), keeps no transposes and copies only the consts before the
// trunk, so the block's shared memory holds the chunk's rows alone and any
// width up to thousands of units plans a chunk. What bounds it: the trunk's
// FLOPs (12.6x the 64-unit trunk's a row at 256 units) on the SMs it gets,
// then the weights' reads from L2. One cluster gives a scenario at most 16
// SMs, and at 256 units P=512 plans 64 chunks of 8 rows. So the form
// spreads a scenario over ApgArgs::groups clusters' worth of blocks
// (sweeps.cuh, the spread note): groups * cluster blocks of a cooperative
// grid, one chunk each at 64 chunks (up to 64 of the 132 SMs), which the
// planner sizes to what the card holds at once for the launch's scenarios
// (ops/cuda/consts.py::plan_groups); groups = 1 is the one cluster. Each
// chunk's partials go to a slot in device memory, and after a barrier over
// the scenario's blocks every block sums the slots in chunk order, so the
// sums, and every loop decision, are those of one block: the bits of any
// groups and cluster. Only the options form is instantiated (risk and
// starts its runtime branches, off without them), in libraries of their own
// (apg_solve_gw.cu, apg_solve_gw_bf16.cu), built in parallel. It is planned
// only where no chunk fits the shared-memory form, and gives its bits
// wherever both run.
//
// The particle options (sweeps.cuh, Risk): with a.risk the vg sweep and the
// candidates price mean + lambda * std of the particles' discounted totals
// (cost_params.risk_lambda; the TPU package sends it to XLA,
// engine/mpc_loader.py:342-345), so the Armijo test compares that
// objective on both sides; `starts` (B, P, 13), when not null, gives each
// particle its initial state (initial_state_std, :346-350), scenario b's at
// b * P * 13. Both are runtime branches of the particle form: the
// unconstrained and constrained forms keep their registers and shared
// memory without them, and a block takes K*Pc floats a chunk more for the
// totals with risk. They are a template parameter of the particle form
// (OPT): apg_solve_kernel<true, SC, false, false> compiles to the code it
// had without them, and a launch with risk or starts takes
// apg_solve_kernel<true, SC, false, true>.
//
// Reduced matmul precision (ApgArgs::bf16; sweeps.cuh): the particle form's
// bf16-trunk instantiations apg_solve_kernel<true, SC, false, OPT, true>,
// in which each block rounds the trunk weights of its consts copy to bf16
// once (before transposing them) and the sweeps store the products' other
// operands rounded: the JAX package's matmul_precision "default", which its
// TPU runs on XLA at P > 128 without pallas_chunk and with the particle
// options (engine/mpc_loader.py:320-350). They are a library of their own,
// apg_solve_bf16.cu, this source compiled with APG_BF16 = 1 (its particle
// forms only, built in parallel with this one): the forms without them keep
// the code they had, and the build keeps its length. Each library refuses
// a launch of the other's precision, and the P=1 form has no bf16 trunk
// (the original runs P=1 on its kernel, at HIGHEST).
//
// The scenario axis (apg_solve.cuh, batch): a launch solves B independent
// problems, scenario b on block b (P=1) or on cluster b (blocks b*C ..
// b*C + C-1), each reading and writing its own slice of the per-scenario
// buffers (consts, u_init, t0, noise; yk, stats, x_evol) at b times their
// stride, and running its own loop and early exit: no predicate crosses
// scenarios, so a scenario's bits are those of its solo launch. B blocks of
// the P=1 form fill up to 132 SMs per wave (one 256-thread block per SM at
// its 220-255 registers); the particle form's clusters of C run
// max_active_clusters at a time. The wrapper (ops/cuda/apg_kernel.py::
// apg_solve_kernel_batched) is the counterpart of the JAX package's vmap
// of the solve (sde4mbrl_px4_tpu/parallel/batched.py::make_batched_mpc),
// and a solo solve is the same launch at B = 1.
//
// Control flow is block-uniform: every loop decision (done, accepted step,
// restart) is computed by thread 0 into shared memory, followed by
// __syncthreads(), and only then read by all threads. Every
// __syncthreads() below is reached by all threads. In the particle form it
// is cluster-uniform: each block's thread 0 decides on the same reduced
// values, so every cluster barrier is reached by every thread of every
// block.
//
// Numerics: fp32 throughout, no fast-math. The step, sweep and cost device
// code lives in sweeps.cuh, shared with the cost-oracle kernels. The Armijo
// candidate steps use the host's float32(decrease_factor**k) table.

#include <cuda_runtime.h>
#include <math.h>

#include "apg_solve.cuh"
#include "sweeps.cuh"

// 1: the library of the P=1 register chain (apg_solve_chain.cu)
#ifndef APG_CHAIN
#define APG_CHAIN 0
#endif
// 1: the library of the bf16-trunk particle forms (apg_solve_bf16.cu)
#ifndef APG_BF16
#define APG_BF16 0
#endif
// 1: the library of the P=1 shared-memory step's forms (apg_solve_p1.cu)
#ifndef APG_P1S
#define APG_P1S 0
#endif
// 1: a library of the particle forms' global-weight forms (apg_solve_gw.cu,
// with APG_BF16 apg_solve_gw_bf16.cu)
#ifndef APG_GW
#define APG_GW 0
#endif
// 1: the library of the P=1 wide step's forms over more than P1_FMAX trunk
// inputs (apg_solve_p1x.cu)
#ifndef APG_P1X
#define APG_P1X 0
#endif
// This library's forms: the fp32 particle forms and their clock-stamped
// form (apg_solve.cu), the P=1 register chain and its clock-stamped form
// (apg_solve_chain.cu), the bf16 particle forms (apg_solve_bf16.cu), the
// P=1 wide step (apg_solve_p1.cu), its forms over more than P1_FMAX inputs
// (apg_solve_p1x.cu) or the particle global-weight forms of one precision
// (apg_solve_gw.cu, apg_solve_gw_bf16.cu); nvcc builds the seven in
// parallel.
#define APG_CHAIN_LIB (APG_CHAIN != 0)
#define APG_PART_LIB (!APG_CHAIN && !APG_P1S && !APG_GW && !APG_P1X)
#define APG_PROF_PART_LIB (APG_PART_LIB && !APG_BF16)

namespace {

constexpr bool kBF = APG_BF16 != 0;     // this library's trunk

static_assert(APG_NTHREADS == 4 * P1_HID && APG_MAXK <= APG_NTHREADS / 32,
              "P=1 layout: 4 threads per hidden unit, one warp per candidate row");

// The block's scenario: its cluster's index in the grid (particles) or its
// own index (P=1), read from the special register where it is used (asm
// volatile: never hoisted), so that no register holds it, or a pointer
// offset by it, across the solve. The clock-stamped forms run one scenario.
template <bool PART, bool PROF = false>
__device__ __forceinline__ size_t scenario() {
  if constexpr (PROF) return 0;
  unsigned b;
  if constexpr (PART) asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(b));
  else asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

struct Scal {
  int k, k_m, no_imp, done, kmax, ok, improved, restart;
  float f_u, t, best_f, sum_t, sum_ls, f0, fval, t0, t_acc, beta;
};

// Carve the dynamic shared memory; returns the number of floats used.
// part: the particle form (a.Pc rows per vg pass, K*Pc candidate rows);
// otherwise every buffer starts on 16 bytes (the P=1 float4 reads), and
// step is the P=1 form (P1_*; the kernel's template constant): the register
// chain and the wide step keep a row's state, features, outputs and
// cotangents in registers; the wide step keeps layer 1's slice sums and the
// transposed output layer here, P1_GLOBAL without the trunk's weights in the
// consts copy. With part, step P1_GLOBAL is the global-weight
// form (no weights and no transposes here, the reverse cotangents at row
// stride tiled_ld: sweeps.cuh, bwd_rows), any other the shared-memory form.
// risk: the risk buffers (a constant false in the forms without the options,
// so their layout compiles as it did without them). far (the wide step's
// global-weight form, wide_far): the wide step's buffers that grow with the
// trunk's width (the vg row's stash h0p, h1p; layer 1's slice sums pp; the
// transposed output layer w2t) are carved from fbase, the scenario's region
// of the launch's scratch in device memory, on 16 bytes as here; *n_far (if
// given) their floats.
__host__ __device__ inline int layout(const ApgArgs& a, bool part, bool risk, Smem* s,
                                      float* base, int step, bool far = false,
                                      float* fbase = nullptr, int* n_far = nullptr) {
  const int HZ = a.H * a.nZ;
  const int B = part ? a.Pc : 1;              // vg rows per pass
  const int R = part ? a.K * a.Pc : a.K;      // candidate rows per pass
  const int ldh = part ? tiled_ld(a) : a.HID;  // hidden row stride (tiled candidates)
  const bool p1s = !part && step != P1_CHAIN;  // the P=1 wide step
  const bool gw = step == P1_GLOBAL;           // the weights in device memory
  const int ldc = part && gw ? tiled_ld(a) : a.HID;   // reverse cotangents' row stride
  int o = 0, of = 0;
  auto take = [&](float** p, int n) {
    if (!part) o = (o + 3) & ~3;
    if (s) *p = base + o;
    o += n;
  };
  auto take_far = [&](float** p, int n) {
    of = (of + 3) & ~3;
    if (s) *p = fbase + of;
    of += n;
  };
  Smem d = {};
  Smem* t = s ? s : &d;
  take(&t->c, gw ? a.o_w0 : a.n_consts);
  take(&t->D, HZ); take(&t->u, HZ); take(&t->y, HZ); take(&t->bu, HZ);
  take(&t->g, HZ); take(&t->yp, HZ); take(&t->gp, HZ);
  take(&t->cand, a.K * HZ);
  take(&t->xs, (a.H + 1) * B * 13);
  if (part) {
    take(&t->p0, B * a.HID); take(&t->p1, B * a.HID);
  } else if (far) {
    take_far(&t->h0p, a.H * a.HID); take_far(&t->h1p, a.H * a.HID);
    take(&t->h2, a.H * a.OUT);
    take(&t->wr, a.H * 4);
  } else {
    take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
    take(&t->h2, a.H * a.OUT);
    take(&t->wr, a.H * 4);
  }
  if (part) { take(&t->xr, R * 13); take(&t->feat, R * a.F); }
  take(&t->a0, R * ldh);
  if (!p1s) take(&t->a1, R * ldh);
  if (part) take(&t->a2, R * a.OUT);
  take(&t->jt, R); take(&t->jr, R);
  if (part) take(&t->ct, B * 13);
  take(&t->cu, B * a.nZ);
  if (part) take(&t->c_h2, B * a.OUT);
  take(&t->c_h1p, B * ldc); take(&t->c_h0p, B * ldc);
  if (part) take(&t->c_feat, B * a.F);
  take(&t->red, 32);
  if (p1s && far) { take_far(&t->pp, kSlices * R * a.HID); take_far(&t->w2t, a.OUT * a.HID); }
  else if (p1s) { take(&t->pp, kSlices * R * a.HID); take(&t->w2t, a.OUT * a.HID); }
  if (part) {
    const int np = risk ? 3 : 2;              // the partial means (risk: + totals)
    take(&t->cacc, np * a.K);
    if (!gw) {
      take(&t->w0t, a.F * a.HID); take(&t->w1t, a.HID * a.HID);
      take(&t->w2t, a.OUT * a.HID);
    }
    // the chunk partials of this block (vg: gradient and 2 costs, + the
    // totals' mean with risk; the K candidates' 2K or 3K means)
    take(&t->pg, a.chunks_per_block * (HZ + np));
    take(&t->pk, a.chunks_per_block * np * a.K);
    // risk: the rows' discounted totals of this block's chunks
    if (risk) take(&t->tot, a.chunks_per_block * R);
  }
  if (n_far) *n_far = of;
  return o;
}

// Whether a P=1 solve of a in form `step` keeps the wide step's width-sized
// buffers in device memory (layout's far): in the global-weight form where
// its block, Scal included, would not fit 227 KB with them (past 624 units
// on the iris traj config, 616 on the hexa's). They are read there, and
// the sums run in the same order, so the bits are the same.
__host__ __device__ inline bool wide_far(const ApgArgs& a, int step) {
  return step == P1_GLOBAL &&
         layout(a, false, false, nullptr, nullptr, P1_GLOBAL) * (int)sizeof(float) +
                 (int)sizeof(Scal) > APG_SMEM_LIMIT_PARTICLES;
}

// Floats of one scenario's region of the scratch with layout's far.
__host__ __device__ inline int wide_far_floats(const ApgArgs& a) {
  int n = 0;
  layout(a, false, false, nullptr, nullptr, P1_GLOBAL, true, nullptr, &n);
  return (n + 3) & ~3;
}

// OPT (particles only): the particle options' form, risk and starts runtime
// branches (sweeps.cuh). PROF (CONSTR_NONE only: the particle form, the
// register chain, the wide step with the weights in shared memory;
// apg_solve_prof_launch): thread 0 stamps
// clock64() at the phase boundaries (sweeps.cuh, PH_* at P=1, PP_* in the
// particle form) and writes the per-phase cycle sums and the solve's cycles
// to prof_out, int64 (2, 8): row 0 from rank 0, row 1 from the cluster's
// last rank (both from the one block at P=1); each row's last entry is the
// block's rank. BF (particles only): the bf16 trunk. STEP: at P=1 the P=1
// form (P1_*): the register chain, or the wide step on any trunk
// (sweeps.cuh, vg_wide / cand_wide; P1_GLOBAL with the weights read from
// scenario 0's consts in device memory); with particles P1_CHAIN (the
// default: the weights in the block's consts copy) or P1_GLOBAL, the global-
// weight form (apg_solve.cuh, part_form; its options form only). The P=1
// wide step's forms state a minimum of one block per SM (their 133 KB block
// at 128 units allows no second): without it, ptxas took the unconstrained
// and proximal forms with the weights in shared memory to 128 registers and
// 52-132 bytes of spill; every other form keeps the bounds it had. FX (the
// wide step only): a trunk of more than P1_FMAX inputs (sweeps.cuh,
// wide_rollout).
template <bool PART, int SC, bool PROF = false, bool OPT = false, bool BF = false,
          int STEP = P1_CHAIN, bool FX = false>
__global__ void __launch_bounds__(PART ? APG_NTHREADS_PART : APG_NTHREADS,
                                  !PART && STEP != P1_CHAIN ? 1 : 0)
apg_solve_kernel(ApgArgs a, const float* __restrict__ consts,
                 const float* __restrict__ u_init, const float* __restrict__ t0p,
                 const float* __restrict__ precond, const float* __restrict__ noise,
                 const float* __restrict__ starts, float* __restrict__ yk,
                 float* __restrict__ stats, float* __restrict__ x_evol,
                 long long* __restrict__ prof_out, float* __restrict__ scratch) {
  static_assert(!PART || STEP == P1_CHAIN || (STEP == P1_GLOBAL && OPT && !PROF),
                "a particle form reads its weights in shared memory or, the options form, "
                "in device memory");
  static_assert(STEP == P1_CHAIN || (!PART && SC == CONSTR_NONE && STEP == P1_SMEM) || !PROF,
                "the clock stamps are the register chain's, the particle form's and the "
                "wide step's with its weights in shared memory");
  static_assert(!FX || (!PART && STEP != P1_CHAIN && !PROF),
                "more than P1_FMAX inputs are the wide step's forms");
  constexpr bool P1S = STEP != P1_CHAIN;   // the P=1 wide step
  constexpr bool GW = STEP == P1_GLOBAL;
  // the particle global-weight form spreads a scenario's chunks over
  // a.groups * a.cluster blocks (sweeps.cuh, the spread note)
  constexpr bool SPREAD = PART && GW;
  extern __shared__ __align__(16) float smem[];
  __shared__ Scal S;
  Smem s;
  if constexpr (!PART && GW) {             // past 227 KB, the scenario's scratch region
    const bool far = wide_far(a, STEP);
    layout(a, false, false, &s, smem, STEP, far,
           far ? scratch + scenario<false, PROF>() * (size_t)wide_far_floats(a) : nullptr);
  } else {
    layout(a, PART, OPT && a.risk, &s, smem, STEP);
  }
  s.prof = nullptr;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, nw = nt >> 5;
  const int HZ = a.H * a.nZ, K = a.K, nZ = a.nZ;
  const float* c = s.c;
  auto scen = [&a] {
    if constexpr (SPREAD) return spread_scenario(a);
    else return scenario<PART, PROF>();
  };
  // this scenario's Brownian block, offset where the sweeps start a chunk
  auto my_noise = [noise, &a]() {
    if constexpr (SPREAD) return noise + spread_scenario(a) * ((size_t)a.H * a.P * 13);
    else return noise + scenario<true, PROF>() * ((size_t)a.H * a.P * 13);
  };
  // ... and (OPT) its particles' starts, or null (every particle at x0),
  // offset once into shared memory
  __shared__ const float* my_starts_p;
  auto my_starts = [&]() -> const float* { return my_starts_p; };
  // the block's rank in its cluster, or among the scenario's blocks with
  // the spread (0 at P=1: one block); only rank 0 writes the outputs
  int rank = 0;
  if constexpr (SPREAD) rank = spread_rank(a);
  else if constexpr (PART) rank = (int)cg::this_cluster().block_rank();
  if constexpr (SPREAD) {
    __shared__ Spread sp;
    spread_init(a, s, &sp, scratch);
  }
  constexpr int LOOP = PART ? (int)PP_LOOP : (int)PH_LOOP;    // the loop's stamp
  long long t_start = 0;
  if constexpr (PROF) {
    __shared__ long long prof[PH_N + 1];
    s.prof = prof;
    if (tid == 0) {
      for (int i = 0; i < PH_N; ++i) prof[i] = 0;
      t_start = prof[PH_N] = clock64();
    }
  }

  // this scenario's outputs, taken once and kept in shared memory for the
  // exit (P=1 only: the particle form's x_evol is the trajectory kernel's)
  __shared__ float* outp[3];               // yk, stats, x_evol
  if (tid == 0) {
    outp[0] = yk + scen() * HZ;
    outp[1] = stats + scen() * 8;
    if constexpr (!PART) outp[2] = x_evol + scen() * ((a.H + 1) * 13);
    if constexpr (OPT)
      my_starts_p = starts ? starts + scen() * ((size_t)a.P * 13) : nullptr;
  }
  const float* const wb = consts;          // GW: the launch's one trunk (scenario 0's)
  consts += scen() * a.n_consts;
  u_init += scen() * HZ;
  for (int i = tid; i < (GW ? a.o_w0 : a.n_consts); i += nt) s.c[i] = consts[i];
  __syncthreads();
  static_assert(PART || !BF, "the P=1 form has no bf16 trunk");
  if constexpr (BF && !GW) {               // the bf16 trunk: its weights, once
    round_trunk_weights(a, s.c);
    __syncthreads();
  }
  P1W W;                                  // the register chain's trunk
  if constexpr (PART) {
    if constexpr (GW) s.wg = wb;          // read in place, rounded where read
    else transpose_weights(a, s);
  } else if constexpr (!P1S) {
    W = load_p1_weights(a, c);
  } else {
    wide_prep<GW>(a, s, wb);
  }
  auto value_grad = [&](const float* U) {
    if constexpr (PART)
      vg_part<SC, PROF, OPT, BF, RISK_IN_CLUSTER, GW, SPREAD>(a, s, &S.fval, U, my_noise,
                                                             my_starts);
    else if constexpr (P1S) vg_wide<SC, GW, PROF, FX>(a, s, wb, &S.fval, U);
    else vg<SC, PROF>(a, s, W, &S.fval, U);
  };
  for (int e = tid; e < HZ; e += nt) {
    const int i = e % nZ;
    const float u0 = clampf(u_init[e], c[a.o_lb + i], c[a.o_ub + i]);
    s.u[e] = u0; s.y[e] = u0; s.bu[e] = u0; s.yp[e] = u0;
    s.D[e] = a.has_pre ? precond[e] : 1.f;
  }
  if (tid == 0) {
    S.k = 0; S.k_m = 0; S.no_imp = 0; S.done = 0;
    S.kmax = a.has_budget ? min(a.max_iter, max(a.budget, 1)) : a.max_iter;
    S.t = t0p[scen()];
    S.sum_t = 0.f; S.sum_ls = 0.f;
  }
  __syncthreads();

  prof_stamp<PROF>(s, LOOP);
  value_grad(s.u);
  for (int e = tid; e < HZ; e += nt) s.gp[e] = s.g[e];
  if (tid == 0) { S.f0 = S.fval; S.f_u = S.fval; S.best_f = S.fval; }
  __syncthreads();

  while (S.k < S.kmax && !S.done) {
    prof_stamp<PROF>(s, LOOP);
    value_grad(s.y);                              // f_y in S.fval, grad in s.g
    prof_stamp<PROF>(s, LOOP);

    // ---- trial stepsize
    if (a.reset_opt == 2) {
      if (warp == 0)
        warp_reduce_to(HZ, [&](int e) { return (s.y[e] - s.yp[e]) * (s.g[e] - s.gp[e]); }, s.red + 0);
      if (warp == 1)
        warp_reduce_to(HZ, [&](int e) {
          const float r = s.g[e] - s.gp[e];
          return r * (s.D[e] * r);
        }, s.red + 1);
      __syncthreads();
    }
    if (tid == 0) {
      const float t_inc = fminf(S.t * a.inc, a.tmax);
      if (a.reset_opt == 2) {
        const float sr = s.red[0], rr = s.red[1];
        const float t_bb = sr / fmaxf(rr, 1e-12f);
        const bool valid = S.k > 0 && sr > 1e-12f;
        S.t0 = valid ? clampf(t_bb, 1e-6f, a.tmax) : t_inc;
      } else {
        S.t0 = a.reset_opt == 0 ? t_inc : S.t;
      }
    }
    __syncthreads();

    // ---- K candidates clip(y - t0 DF^k D g) as rows of one rollout
    const float t0 = S.t0;
    for (int e = tid; e < K * HZ; e += nt) {
      const int k = e / HZ, r = e - k * HZ, i = r % nZ;
      const float tk = t0 * a.dfp[k];
      s.cand[e] = clampf(s.y[r] - tk * (s.D[r] * s.g[r]), c[a.o_lb + i], c[a.o_ub + i]);
    }
    if constexpr (PART) {
      cand_part<SC, PROF, OPT, BF, RISK_IN_CLUSTER, GW, SPREAD>(a, s, K, my_noise, my_starts);
    } else if constexpr (P1S) {
      __syncthreads();                            // the candidate rows
      prof_stamp<PROF>(s, PH_LOOP);
      cand_wide<SC, GW, FX>(a, s, wb, K);
      prof_stamp<PROF>(s, PH_CAND);
    } else {
      __syncthreads();                            // the candidate rows
      prof_stamp<PROF>(s, PH_LOOP);
      p1_rollout<SC, false, false>(a, s, W, K, s.cand, HZ);
      prof_stamp<PROF>(s, PH_CAND);
    }
    // rollout costs per candidate: the rows' own (P=1) or particle means
    // (the tracking mean with lambda * std under risk)
    const float* cost_t = PART ? s.cacc : s.jt;
    const float* cost_r = PART ? s.cacc + K : s.jr;

    // ---- per-candidate control cost, <g, d>, <d, D^-1 d>
    for (int j = warp; j < 3 * K; j += nw) {
      const int k = j / 3, kind = j - 3 * k;
      const float* Uk = s.cand + k * HZ;
      if (kind == 0) {
        const float* scal = c + a.o_scal;
        warp_reduce_to(HZ, [&](int e) {
          const CtrlTerms ct = ctrl_terms<SC>(a, c, Uk, e);
          float cc = scal[SC_UERR] * ct.u + scal[SC_SLEW] * ct.sl;
          if (a.has_slew) cc = cc + scal[SC_SLEWC] * ct.viol;
          return cc;
        }, s.red + j);
      } else if (kind == 1) {
        warp_reduce_to(HZ, [&](int e) { return s.g[e] * (Uk[e] - s.y[e]); }, s.red + j);
      } else {
        warp_reduce_to(HZ, [&](int e) {
          const float d = Uk[e] - s.y[e];
          return d * d / s.D[e];
        }, s.red + j);
      }
    }
    __syncthreads();

    // ---- Armijo accept (first = largest passing step), momentum, stops
    if (tid == 0) {
      const float f_y = S.fval;
      const float res_mult = c[a.o_scal + SC_RESM];
      float t_acc = t0 * a.dfp[K], f_new_s = f_y, n_ls = (float)K;
      int ok = 0;
      for (int ki = K - 1; ki >= 0; --ki) {
        const float tk = t0 * a.dfp[ki];
        const float fk = (cost_t[ki] + res_mult * cost_r[ki]) + s.red[3 * ki];
        const float bound = f_y + a.one_m_coef * s.red[3 * ki + 1]
                            + s.red[3 * ki + 2] / (2.f * fmaxf(tk, 1e-12f));
        if (fk <= bound) { t_acc = tk; f_new_s = fk; n_ls = (float)(ki + 1); ok = 1; }
      }
      const float f_new = ok ? f_new_s : S.f_u;
      const float kf = (float)(a.mom_restart ? S.k_m : S.k);
      S.beta = a.has_moment_scale ? a.moment_scale : fmaxf(kf / (kf + 3.f), a.beta_init);
      S.restart = !ok || f_new > S.f_u;
      S.k_m = S.restart ? 0 : S.k_m + 1;
      S.improved = f_new < S.best_f - 1e-12f;
      S.best_f = fminf(f_new, S.best_f);
      S.no_imp = S.improved ? 0 : S.no_imp + 1;
      const bool conv = ok && fabsf(S.f_u - f_new) <= a.atol + a.rtol * fabsf(S.f_u);
      S.done = conv || S.no_imp >= a.max_no_imp;
      S.ok = ok;
      S.t_acc = t_acc;
      S.f_u = f_new;
      S.t = t_acc;
      S.sum_t = S.sum_t + t_acc;
      S.sum_ls = S.sum_ls + n_ls;
      S.k = S.k + 1;
    }
    __syncthreads();

    // ---- iterate update (elementwise; recomputes the accepted candidate)
    {
      const float t_acc = S.t_acc, beta = S.beta;
      const int ok = S.ok, restart = S.restart, improved = S.improved;
      for (int e = tid; e < HZ; e += nt) {
        const int i = e % nZ;
        const float yv = s.y[e], gv = s.g[e], uo = s.u[e];
        const float ut = clampf(yv - t_acc * (s.D[e] * gv), c[a.o_lb + i], c[a.o_ub + i]);
        const float un = ok ? ut : uo;
        const float yn = restart ? un : un + beta * (un - uo);
        if (improved) s.bu[e] = un;
        s.yp[e] = yv;
        s.gp[e] = gv;
        s.u[e] = un;
        s.y[e] = yn;
      }
    }
    __syncthreads();
  }

  // ---- exit gradient at the best iterate; at P=1 its forward states are
  // x_evol (the particle form's are sample paths: x_evol comes from the
  // trajectory kernel)
  value_grad(s.bu);
  if (warp == 0) warp_reduce_to(HZ, [&](int e) { return s.g[e] * s.g[e]; }, s.red + 0);
  if (rank == 0)
    for (int e = tid; e < HZ; e += nt) outp[0][e] = s.bu[e];
  if constexpr (!PART)
    for (int e = tid; e < (a.H + 1) * 13; e += nt) outp[2][e] = s.xs[e];
  __syncthreads();
  if (tid == 0 && rank == 0) {
    stats = outp[1];
    const float n_steps = fmaxf((float)S.k, 1.f);
    stats[0] = (float)S.k;
    stats[1] = S.t;
    stats[2] = S.sum_t / n_steps;
    stats[3] = S.sum_ls / n_steps;
    stats[4] = s.red[0];
    stats[5] = S.f0;
    stats[6] = S.best_f;
    stats[7] = 0.f;
  }
  if constexpr (PROF) {
    if (tid == 0) {
      prof_stamp<PROF>(s, LOOP);
      const long long total = clock64() - t_start;
      for (int row = 0; row < 2; ++row) {
        if (rank != (row == 0 ? 0 : a.cluster - 1)) continue;
        long long* out = prof_out + row * (PH_N + 2);
        for (int i = 0; i < PH_N; ++i) out[i] = s.prof[i];
        out[PH_N] = total;
        out[PH_N + 1] = rank;
      }
    }
  }
}

// The P=1 form of a's solve (apg_solve.cuh, p1_form): the weights in shared
// memory where the block, its Scal included, fits 227 KB with them.
int p1_form_of(const ApgArgs& a) {
  return p1_form(a, [&a](int step) {
    return layout(a, false, false, nullptr, nullptr, step) * (int)sizeof(float) +
               (int)sizeof(Scal) <= APG_SMEM_LIMIT_PARTICLES;
  });
}

// The particle form of a's solve (apg_solve.cuh, part_form): the weights
// in shared memory where the block, its Scal included, fits 227 KB with them
// and a's chunk.
int part_form_of(const ApgArgs& a) {
  return part_form(a, [&a](int step) {
    return layout(a, true, a.risk != 0, nullptr, nullptr, step) * (int)sizeof(float) +
               (int)sizeof(Scal) <= APG_SMEM_LIMIT_PARTICLES;
  });
}

int dyn_bytes(const ApgArgs& a) {
  const bool part = a.has_noise != 0;
  const int step = part ? part_form_of(a) : p1_form_of(a);
  return layout(a, part, a.risk != 0, nullptr, nullptr, step, !part && wide_far(a, step)) *
         (int)sizeof(float);
}

// Whether a's launch keeps the wide step's buffers in its scratch (wide_far).
bool far_of(const ApgArgs& a) { return !a.has_noise && wide_far(a, p1_form_of(a)); }

// One launch of a.batch scenarios: P=1 one block each; the particle form
// one cluster of a.cluster blocks each (cudaLaunchKernelEx, whose error a
// cluster the card cannot schedule returns), the global-weight form with
// a.groups > 1 a.groups * a.cluster blocks each on a cooperative grid
// (launch_spread, whose error a grid the card cannot hold at once returns),
// in this library's precision.
template <bool PART, int SC, bool PROF = false, bool OPT = false, int STEP = P1_CHAIN,
          bool FX = false>
cudaError_t launch(const ApgArgs& a, size_t dyn, cudaStream_t st, const float* consts,
                   const float* u_init, const float* t0, const float* precond,
                   const float* noise, const float* starts, float* yk, float* stats,
                   float* x_evol, long long* prof, float* scratch) {
  if constexpr (PART) {
    if constexpr (STEP == P1_GLOBAL)
      if (a.groups > 1)
        return launch_spread(apg_solve_kernel<true, SC, PROF, OPT, kBF, STEP>, a,
                             APG_NTHREADS_PART, dyn, st, scratch, a, consts, u_init, t0,
                             precond, noise, starts, yk, stats, x_evol, prof, scratch);
    ClusterLaunch l(a.cluster, APG_NTHREADS_PART, dyn, st, a.batch);
    return cudaLaunchKernelEx(&l.cfg, apg_solve_kernel<true, SC, PROF, OPT, kBF, STEP>, a,
                              consts, u_init, t0, precond, noise, starts, yk, stats, x_evol,
                              prof, scratch);
  } else {
    apg_solve_kernel<false, SC, PROF, false, false, STEP, FX><<<a.batch, APG_NTHREADS, dyn, st>>>(
        a, consts, u_init, t0, precond, noise, starts, yk, stats, x_evol, prof, scratch);
    return cudaSuccess;
  }
}

// The instantiation for [form][sc_kind]: form 0 P=1 on the register chain,
// 3 on the wide step, 4 on it with the weights in device memory, 6 and 7 the
// two over more than P1_FMAX inputs (FX; none of the five in the bf16
// library), 1 particles, 2 the particles with the options (OPT), 5 the
// particles' global-weight form (OPT; the global-weight libraries' only
// forms).
using LaunchFn = cudaError_t (*)(const ApgArgs&, size_t, cudaStream_t, const float*,
                                 const float*, const float*, const float*, const float*,
                                 const float*, float*, float*, float*, long long*, float*);
#define P1_STEP_FORMS(STEP, FX)                                                            \
  {launch<false, CONSTR_NONE, false, false, STEP, FX>,                                     \
   launch<false, CONSTR_PENALTY, false, false, STEP, FX>,                                  \
   launch<false, CONSTR_PROX, false, false, STEP, FX>}
#define NO_FORMS {nullptr, nullptr, nullptr}
const LaunchFn kLaunch[8][3] = {
#if APG_CHAIN_LIB
    {launch<false, CONSTR_NONE>, launch<false, CONSTR_PENALTY>, launch<false, CONSTR_PROX>},
#else
    NO_FORMS,
#endif
#if APG_PART_LIB
    {launch<true, CONSTR_NONE>, launch<true, CONSTR_PENALTY>, launch<true, CONSTR_PROX>},
    {launch<true, CONSTR_NONE, false, true>, launch<true, CONSTR_PENALTY, false, true>,
     launch<true, CONSTR_PROX, false, true>},
#else
    NO_FORMS, NO_FORMS,
#endif
#if APG_P1S
    P1_STEP_FORMS(P1_SMEM, false), P1_STEP_FORMS(P1_GLOBAL, false),
#else
    NO_FORMS, NO_FORMS,
#endif
#if APG_GW
    {launch<true, CONSTR_NONE, false, true, P1_GLOBAL>,
     launch<true, CONSTR_PENALTY, false, true, P1_GLOBAL>,
     launch<true, CONSTR_PROX, false, true, P1_GLOBAL>},
#else
    NO_FORMS,
#endif
#if APG_P1X
    P1_STEP_FORMS(P1_SMEM, true), P1_STEP_FORMS(P1_GLOBAL, true)};
#else
    NO_FORMS, NO_FORMS};
#endif

using KernelFn = void (*)(ApgArgs, const float*, const float*, const float*, const float*,
                          const float*, const float*, float*, float*, float*, long long*,
                          float*);
#if APG_PART_LIB
// This library's particle forms [opt][sc_kind].
const KernelFn kPart[2][3] = {
    {apg_solve_kernel<true, CONSTR_NONE, false, false, kBF>,
     apg_solve_kernel<true, CONSTR_PENALTY, false, false, kBF>,
     apg_solve_kernel<true, CONSTR_PROX, false, false, kBF>},
    {apg_solve_kernel<true, CONSTR_NONE, false, true, kBF>,
     apg_solve_kernel<true, CONSTR_PENALTY, false, true, kBF>,
     apg_solve_kernel<true, CONSTR_PROX, false, true, kBF>}};
#endif
#if APG_GW
// This library's global-weight forms [sc_kind].
const KernelFn kPartGW[3] = {apg_solve_kernel<true, CONSTR_NONE, false, true, kBF, P1_GLOBAL>,
                             apg_solve_kernel<true, CONSTR_PENALTY, false, true, kBF, P1_GLOBAL>,
                             apg_solve_kernel<true, CONSTR_PROX, false, true, kBF, P1_GLOBAL>};
#endif

// This library's particle kernel for a's form, or null (another library's).
KernelFn part_kernel(const ApgArgs& a) {
  const bool gw = part_form_of(a) == P1_GLOBAL;
#if APG_PART_LIB
  return gw ? nullptr : kPart[options(a)][a.sc_kind];
#elif APG_GW
  return gw ? kPartGW[a.sc_kind] : nullptr;
#else
  (void)gw;
  return nullptr;
#endif
}

int form(const ApgArgs& a) {
  if (a.has_noise) return part_form_of(a) == P1_GLOBAL ? 5 : options(a) ? 2 : 1;
  const int step = p1_form_of(a);
  const int fx = a.F > P1_FMAX ? 3 : 0;      // more inputs than the registers of 3 and 4
  return step == P1_CHAIN ? 0 : (step == P1_SMEM ? 3 : 4) + fx;
}

// The largest cluster of each particle form [opt][sc_kind] and of the
// clock-stamped one (apg_init; 0 before it); in a global-weight library its
// one form's under both opt.
int g_cmax[2][3] = {};
int g_cmax_prof = 0;

}  // namespace

extern "C" {

int apg_args_size() { return (int)sizeof(ApgArgs); }

// Let the particle forms, the constrained P=1 forms and the P=1
// shared-memory step take dynamic shared memory up to the card's 227 KB
// less their static shared memory (the unconstrained register chain stays
// inside the 48 KB default), and find each particle form's largest cluster
// (sweeps.cuh::cluster_max). Called once when the library is loaded;
// returns a cudaError_t.
int apg_init() {
#if APG_PART_LIB
  for (int o = 0; o < 2; ++o)
    for (int sc = CONSTR_NONE; sc <= CONSTR_PROX; ++sc) {
      cudaError_t e = allow_large_smem(kPart[o][sc]);
      if (e == cudaSuccess) e = cluster_max(kPart[o][sc], APG_NTHREADS_PART, &g_cmax[o][sc]);
      if (e != cudaSuccess) return (int)e;
    }
#endif
#if APG_GW
  for (int sc = CONSTR_NONE; sc <= CONSTR_PROX; ++sc) {
    cudaError_t e = allow_large_smem(kPartGW[sc]);
    if (e == cudaSuccess) e = cluster_max(kPartGW[sc], APG_NTHREADS_PART, &g_cmax[1][sc]);
    if (e != cudaSuccess) return (int)e;
    g_cmax[0][sc] = g_cmax[1][sc];
  }
#endif
#if APG_PROF_PART_LIB
  const cudaError_t errs[] = {
      allow_large_smem(apg_solve_kernel<true, CONSTR_NONE, true>),
      cluster_max(apg_solve_kernel<true, CONSTR_NONE, true>, APG_NTHREADS_PART,
                  &g_cmax_prof)};
#elif APG_CHAIN_LIB
  const cudaError_t errs[] = {
      allow_large_smem(apg_solve_kernel<false, CONSTR_PENALTY>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_PROX>)};
#elif APG_P1X
  const cudaError_t errs[] = {
      allow_large_smem(apg_solve_kernel<false, CONSTR_NONE, false, false, false, P1_SMEM, true>),
      allow_large_smem(
          apg_solve_kernel<false, CONSTR_PENALTY, false, false, false, P1_SMEM, true>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_PROX, false, false, false, P1_SMEM, true>),
      allow_large_smem(
          apg_solve_kernel<false, CONSTR_NONE, false, false, false, P1_GLOBAL, true>),
      allow_large_smem(
          apg_solve_kernel<false, CONSTR_PENALTY, false, false, false, P1_GLOBAL, true>),
      allow_large_smem(
          apg_solve_kernel<false, CONSTR_PROX, false, false, false, P1_GLOBAL, true>)};
#elif APG_P1S
  const cudaError_t errs[] = {
      allow_large_smem(apg_solve_kernel<false, CONSTR_NONE, true, false, false, P1_SMEM>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_NONE, false, false, false, P1_SMEM>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_PENALTY, false, false, false, P1_SMEM>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_PROX, false, false, false, P1_SMEM>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_NONE, false, false, false, P1_GLOBAL>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_PENALTY, false, false, false, P1_GLOBAL>),
      allow_large_smem(apg_solve_kernel<false, CONSTR_PROX, false, false, false, P1_GLOBAL>)};
#else
  const cudaError_t errs[] = {cudaSuccess};
#endif
  for (const cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// The largest cluster the particle form of sc_kind takes (prof: the
// clock-stamped one, CONSTR_NONE only; opt: the options' form).
int apg_cluster_max(int sc_kind, int prof, int opt) {
  if (sc_kind < CONSTR_NONE || sc_kind > CONSTR_PROX) return 0;
  return prof ? g_cmax_prof : g_cmax[opt != 0][sc_kind];
}

// Shared memory the kernel needs for these dimensions (dynamic + static).
int apg_smem_bytes(const ApgArgs* a) {
  return dyn_bytes(*a) + (int)sizeof(Scal);
}

// The P=1 form (P1_*) a solve with a's dimensions runs (p1_form_of).
int apg_p1_form(const ApgArgs* a) { return p1_form_of(*a); }

// The particle form (P1_SMEM, P1_GLOBAL) a solve with a's dimensions and
// chunk runs (part_form_of).
int apg_part_form(const ApgArgs* a) { return part_form_of(*a); }

// cudaOccupancyMaxActiveClusters of the particle form for a's dimensions
// and cluster size, into *n; returns a cudaError_t.
int apg_max_active_clusters(const ApgArgs* a, int* n) {
  if (!a->has_noise || a->sc_kind < CONSTR_NONE || a->sc_kind > CONSTR_PROX || a->cluster < 1)
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = part_kernel(*a);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;   // another library's form
  return (int)max_active_clusters(fn, a->cluster, APG_NTHREADS_PART, (size_t)dyn_bytes(*a), n);
}

// How many blocks of the global-weight form for a's dimensions and chunk
// the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SMs), into *n: the bound on a spread launch's batch * groups *
// cluster (ops/cuda/consts.py::plan_groups); returns a cudaError_t.
int apg_resident_blocks(const ApgArgs* a, int* n) {
  if (!a->has_noise || a->sc_kind < CONSTR_NONE || a->sc_kind > CONSTR_PROX ||
      part_form_of(*a) != P1_GLOBAL)
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = part_kernel(*a);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;   // another library's form
  return (int)resident_blocks(fn, APG_NTHREADS_PART, (size_t)dyn_bytes(*a), n);
}

// Floats of the scratch a launch with a's plan takes: with particles
// apg_solve.cuh's spread_floats (0 but for the global-weight form at
// groups > 1), at P=1 a region a scenario where the wide step keeps its
// width-sized buffers in device memory (wide_far), else 0.
long long apg_scratch_floats(const ApgArgs* a) {
  if (a->has_noise) return spread_floats(*a);
  return far_of(*a) ? (long long)a->batch * wide_far_floats(*a) : 0;
}

const char* apg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The arguments a launch takes (a refused launch returns
// cudaErrorInvalidValue and runs nothing): among them B >= 1 scenarios on a
// grid the card takes (at most 2^31 - 1 blocks), groups > 1 only in the
// global-weight form; cmax: the particle form's largest cluster.
static bool launch_ok(const ApgArgs* a, const void* precond, const void* noise,
                      const void* starts, const void* x_evol, int cmax) {
  const bool part = a->has_noise != 0;
  const int step = part ? part_form_of(*a) : p1_form_of(*a);
  const int limit = part || a->sc_kind != CONSTR_NONE || step != P1_CHAIN
                        ? APG_SMEM_LIMIT_PARTICLES : APG_SMEM_LIMIT;
  const long long blocks = (long long)a->batch * (part ? (long long)a->cluster * a->groups : 1);
  return !(a->batch < 1 || blocks > 2147483647LL ||
           a->K < 1 || a->K > APG_MAXK || !constr_args_ok(*a) || a->OUT != P1_OUT ||
           a->F != 9 + a->n_u || apg_smem_bytes(a) > limit ||
           (part ? !part_form_ok(*a, step) : !p1_form_ok(*a, step)) ||
           (a->has_pre && precond == nullptr) ||
           (a->has_starts != 0) != (starts != nullptr) || (!part && options(*a)) ||
           (a->bf16 != 0) != kBF || (!part && kBF) ||
           (part ? (noise == nullptr || a->Pc < 1 || a->n_chunks < 1 ||
                    a->Pc * a->n_chunks != a->P ||
                    !cluster_args_ok(*a, cmax, step == P1_GLOBAL))
                 : (x_evol == nullptr || a->P != 1 || a->Pc != 1 || a->n_chunks != 1 ||
                    a->cluster != 1 || a->chunks_per_block != 1 || a->groups != 1)));
}

// Launch a->batch solves on `stream`. Per scenario (leading axis B): consts
// (n_consts), u_init and yk (H, nZ), t0 (1), stats (8), noise the
// (H, P, 13) Brownian block when a->has_noise (else unused, may be null),
// starts the (P, 13) particles' initial states or null (particles only,
// with a->has_starts), x_evol (H+1, 13), written only by the deterministic
// form; precond (H, nZ) is shared by every scenario; a->risk (particles
// only) prices the particles' totals at mean + lambda * std; a P=1 solve
// runs the form p1_form_of picks (or a->step names); scratch, the
// global-weight form's at a->groups > 1, apg_scratch_floats floats (null
// otherwise). Returns the launch's error (cudaErrorInvalidValue for
// arguments the kernel does not take, among them a P=1 form the trunk's
// widths or the form's shared memory do not take, a form of another
// library, a particle launch whose cluster fields are no plan of its chunks
// and a spread launch without its scratch; the cluster launch's own error
// where the card cannot schedule the cluster, and the cooperative launch's
// where it cannot hold a spread launch's grid at once).
int apg_solve_launch(const ApgArgs* a, const void* consts, const void* u_init,
                     const void* t0, const void* precond, const void* noise,
                     const void* starts, void* yk, void* stats, void* x_evol,
                     void* scratch, void* stream) {
  if (a->sc_kind < CONSTR_NONE || a->sc_kind > CONSTR_PROX ||
      !launch_ok(a, precond, noise, starts, x_evol, g_cmax[options(*a)][a->sc_kind]) ||
      (far_of(*a) && scratch == nullptr) ||
      kLaunch[form(*a)][a->sc_kind] == nullptr)   // a form of another library
    return (int)cudaErrorInvalidValue;
  return launch_error(kLaunch[form(*a)][a->sc_kind](
      *a, (size_t)dyn_bytes(*a), (cudaStream_t)stream, (const float*)consts,
      (const float*)u_init, (const float*)t0, (const float*)precond, (const float*)noise,
      (const float*)starts, (float*)yk, (float*)stats, (float*)x_evol, nullptr,
      (float*)scratch));
}

// A solve without state constraints and particle options through the
// clock-stamped instantiation (apg_solve_kernel<PART, CONSTR_NONE, true>;
// P=1 or particles; one scenario, batch = 1; fp32, this library only), for
// measurement: as apg_solve_launch, plus prof (int64
// (2, 8)): per stamped rank the cycles of the PH_* (P=1) or PP_* (particle)
// phases, of the whole solve, and the rank.
int apg_solve_prof_launch(const ApgArgs* a, const void* consts, const void* u_init,
                          const void* t0, const void* precond, const void* noise,
                          const void* starts, void* yk, void* stats, void* x_evol,
                          void* prof, void* stream) {
  // the clock-stamped P=1 forms are apg_solve_chain.cu's (the register
  // chain) and apg_solve_p1.cu's (the wide step with its weights in shared
  // memory), the particle one apg_solve.cu's
  const int p1 = a->has_noise ? -1 : p1_form_of(*a);
#if APG_CHAIN_LIB
  const LaunchFn fn = p1 == P1_CHAIN ? &launch<false, CONSTR_NONE, true> : nullptr;
#elif APG_P1S     // (its forms of up to P1_FMAX inputs)
  const LaunchFn fn = p1 == P1_SMEM && a->F <= P1_FMAX
                          ? &launch<false, CONSTR_NONE, true, false, P1_SMEM> : nullptr;
#elif APG_PROF_PART_LIB
  const LaunchFn fn = a->has_noise ? &launch<true, CONSTR_NONE, true> : nullptr;
#else
  const LaunchFn fn = nullptr;
#endif
  if (fn == nullptr || a->sc_kind != CONSTR_NONE || prof == nullptr || a->batch != 1 ||
      options(*a) || a->groups != 1 || (a->has_noise && part_form_of(*a) != P1_SMEM) ||
      !launch_ok(a, precond, noise, starts, x_evol, g_cmax_prof))
    return (int)cudaErrorInvalidValue;
  return launch_error(fn(*a, (size_t)dyn_bytes(*a), (cudaStream_t)stream,
                         (const float*)consts, (const float*)u_init, (const float*)t0,
                         (const float*)precond, (const float*)noise, (const float*)starts,
                         (float*)yk, (float*)stats, (float*)x_evol, (long long*)prof,
                         nullptr));
}

}  // extern "C"
