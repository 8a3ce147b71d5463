// ABI of the whole-solve APG kernel: the argument struct and the layout of
// its flat fp32 consts buffer. The Python mirror is
// sde4mbrl_px4_tpu_torch/ops/cuda/consts.py::ApgArgs (same field order;
// every field is 4 bytes, so there is no padding). apg_args_size() lets the
// wrapper check that both sides agree.
#pragma once

#define APG_MAXK 8          // largest maxls (linesearch candidates) supported
#define APG_NTHREADS 256    // threads per block (one block per solve)
#define APG_NTHREADS_PART 512  // ... in the particle form (more rows per step)
#define APG_SMEM_LIMIT 49152  // static + dynamic shared memory budget (bytes), P=1 chain
// Budget of the particle path (has_noise): all of a block's shared memory on
// sm_90 (227 KB), taken as dynamic shared memory after
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize, ...)
// (apg_init).
#define APG_SMEM_LIMIT_PARTICLES 232448
// The P=1 register chain holds the trunk in registers at fixed widths
// (sweeps.cuh, P1W): the hidden width, the largest input width F = 9 + n_u,
// the output width. Its block is 4 threads per hidden unit (APG_NTHREADS),
// and the K <= APG_MAXK candidate rows are one warp each. Other trunks run
// the P=1 forms P1_SMEM or P1_GLOBAL (p1_form, below).
#define P1_HID 64
#define P1_FMAX 16
#define P1_OUT 12

// The P=1 forms of every kernel (a template parameter of the kernels):
// P1_CHAIN the register chain (trunks of P1W's widths only); P1_SMEM a step
// on any trunk with the weights in the block's shared-memory copy of the
// consts (the whole solve and value_and_grad: the wide step, sweeps.cuh
// vg_wide / cand_wide; value_batch and trajectory: the shared-memory step,
// fwd_step<false>, a thread per trunk output); P1_GLOBAL the same steps with
// the weights read from device memory (L2-resident; the block copies only
// the consts before them, `trunk_last`). Each library picks a launch's form
// from its dimensions (p1_form, below, with that kernel's own layout):
// the chain on P1W's widths, else P1_SMEM where the kernel's block fits
// 227 KB with the weights, else P1_GLOBAL. Both step forms give the same
// bits; P1_SMEM is up to 30 % faster at 72-128 units (the wide step;
// alike at 32) and 10-20 % in value_batch and trajectory
// (sde4mbrl_px4_tpu_torch/p1_step_ab.py). ApgArgs::step asks for that
// choice (P1_BY_SHAPE) or names a form, which the launch then takes or
// refuses (for measurement).
enum { P1_BY_SHAPE = -1, P1_CHAIN = 0, P1_SMEM = 1, P1_GLOBAL = 2 };

struct ApgArgs {
  // dimensions
  int H, n_u, nZ, K, F, HID, OUT;
  // Monte-Carlo particles: P paths in n_chunks passes of Pc rows; the
  // Brownian block (H, P, 13) is a separate device pointer. has_noise = 0 is
  // the deterministic mean-dynamics path (P = Pc = n_chunks = 1).
  int P, Pc, n_chunks, has_noise;
  // solver options
  int max_iter, max_no_imp, budget, has_budget, has_pre, has_slew;
  int reset_opt;            // 0 increase, 1 conservative, 2 Barzilai-Borwein
  int mom_restart, has_moment_scale;
  // float offsets into the consts buffer
  int o_x0, o_xref, o_uprev, o_w0, o_b0, o_w1, o_b1, o_w2, o_b2, o_mix;
  int o_inertia, o_ts, o_disc, o_wstate, o_uref, o_slo, o_shi, o_scal;
  int o_lb, o_ub, n_consts;
  // config scalars (fp32 casts of the Python doubles)
  float inc, one_m_coef, tmax, beta_init, moment_scale, atol, rtol;
  float dfp[APG_MAXK + 1];  // float32(decrease_factor**k), k = 0..K
  // state constraints (the state_constr block): sc_kind selects the
  // kernels' compile-time form (CONSTR_*); m slack columns past n_u in the
  // proximal form (nZ = n_u + m), 0 otherwise. Offsets of the proximal
  // block (penm, invm, the state ids as floats; m each) or of the penalty
  // block (pen13 with constr_pen folded in, lo13, hi13, inv13; 13 each).
  int sc_kind, m, o_penm, o_invm, o_sid, o_pen13, o_lo13, o_hi13, o_inv13;
  // The particle options (sweeps.cuh, Risk): risk = 1 prices the
  // particles' discounted totals at mean + lambda * std (cost_params.
  // risk_lambda, lambda at scal[SC_RISK]); has_starts = 1 when the launch
  // passes the particles' starts (initial_state_std). Both 0 at P = 1; a
  // particle launch with either runs the kernels' OPT forms. risk_mode
  // (RISK_*, below) is where a risk launch of the oracle kernels gets the
  // moments of its particles' totals: 0 from its own cluster (every other
  // kernel, and the default); the particle-sharded solve's value_batch
  // writes them out, its value_and_grad reads them in.
  int risk, has_starts, risk_mode;
  // The scenario axis of every kernel: `batch` independent problems in one
  // launch (B >= 1). The whole solve, value_and_grad and trajectory take
  // scenario b on one block (P=1) or one cluster (particles); value_batch
  // on row b of its grid's y dimension (P=1) or on clusters b*K .. b*K+K-1
  // (particles). Per-scenario inputs and outputs lie
  // at b times their stride: consts n_consts, u_init and yk H*nZ, t0 1,
  // stats 8, x_evol (H+1)*13, noise H*P*13, value_batch's plans K*H*nZ and
  // costs K, value_and_grad's plan and gradient H*nZ and value 1; precond
  // is shared.
  int batch;
  // The trunk's three products on bf16-rounded operands with fp32 sums
  // (bf16 = 1; the JAX package's matmul_precision "default" on its TPU).
  // It selects the template instantiations with BF = true: the whole
  // solve's particle forms from the apg_solve_bf16 library
  // (apg_solve_bf16.cu), value_batch's (particle and P=1) and
  // value_and_grad's particle forms from cost_oracle.cu. A launcher refuses
  // a launch whose bf16 differs from its instantiations' precision; the P=1
  // whole solve and value_and_grad refuse it, and trajectory ignores it
  // (x_evol stays fp32).
  int bf16;
  // The trunk's form a launch runs: P1_BY_SHAPE (ops/cuda/consts.py::
  // build_consts), the library's choice, or the P1_* form named (for
  // measurement), which the launch takes or refuses. The P=1 kernels and
  // trajectory read it through p1_form, the particle forms through
  // part_form (P1_SMEM or P1_GLOBAL). P1_GLOBAL reads the trunk of scenario
  // 0's consts: every scenario of a launch shares it.
  int step;
  // The particle forms of the whole solve and of value_and_grad: one
  // thread-block cluster of `cluster` blocks per launch; block `rank`
  // sweeps chunks rank, rank + cluster, ... (at most chunks_per_block of
  // them). 1 and 1 elsewhere.
  int cluster, chunks_per_block;
  // The spread of the global-weight forms of the whole solve and of
  // value_and_grad (part_form P1_GLOBAL; sweeps.cuh, the spread note).
  // What bounds those forms is the trunk's FLOPs on the SMs they get, then
  // the weights' reads from L2, and one cluster is at most 16 SMs; so a
  // scenario runs on groups * cluster blocks, block j sweeping chunks j,
  // j + groups * cluster, ... (chunks_per_block counts them over all the
  // scenario's blocks). groups = 1 is the one cluster above; past it the
  // scenario's blocks are plain blocks of a cooperative grid, and the chunk
  // partials meet in the launch's scratch in device memory (spread_floats),
  // summed in chunk order, so every groups gives one cluster's bits. 1 for
  // every other form (the wrappers plan it, ops/cuda/consts.py::
  // plan_groups).
  int groups;
};

// The spread forms' scratch in device memory (ApgArgs::groups > 1), which
// the wrapper allocates and the launcher's memset zeroes the counters of:
// first one arrival counter per scenario, SPREAD_CTR 4-byte words apart
// (its own 128-byte line), then per scenario two regions (the chunk sums
// alternate between them, so a region is written again only after a
// barrier that every block reaches once it has read it) of n_chunks slots
// of spread_width floats: the widest chunk partial of a sum, value_and_grad's
// gradient and three means (H*nZ + 3) or the K candidates' three means
// (3K).
#define SPREAD_CTR 32
__host__ __device__ inline int spread_width(const ApgArgs& a) {
  return a.H * a.nZ + 3 > 3 * a.K ? a.H * a.nZ + 3 : 3 * a.K;
}
__host__ __device__ inline long long spread_region(const ApgArgs& a) {
  return (long long)a.n_chunks * spread_width(a);
}
// Floats of a launch's scratch (0 at groups = 1: no scratch).
inline long long spread_floats(const ApgArgs& a) {
  return a.groups > 1 ? (long long)a.batch * (SPREAD_CTR + 2 * spread_region(a)) : 0;
}

// The largest cluster the particle forms take: 16 blocks where the card
// schedules one at the form's block size and shared memory (a non-portable
// size), else the portable 8 (sweeps.cuh::cluster_max).
#define CLUSTER_MAX 16
#define CLUSTER_PORTABLE 8

// The state-constraint forms, a template parameter of the kernels so that
// the unconstrained forms compile to the code they had without them.
enum { CONSTR_NONE = 0, CONSTR_PENALTY = 1, CONSTR_PROX = 2 };

// Whether a launch takes the particle options' forms (OPT = true).
inline bool options(const ApgArgs& a) { return a.risk != 0 || a.has_starts != 0; }

// The risk modes (ApgArgs::risk_mode; a template parameter RM of the
// oracle's options forms, sweeps.cuh's Risk note). IN_CLUSTER: the moments
// of the totals over the launch's own P particles, two ordered cluster sums
// (the one-process solve). MOMENTS_OUT (value_batch): each plan's
// risk-free cost, the mean of its totals and their centred second moment,
// over the launch's particles, written out for the host to combine across
// the blocks of particles of a sharded solve. MOMENTS_IN (value_and_grad):
// the mean and std of the totals over all particles read in per scenario,
// and the rows weighed with them.
enum { RISK_IN_CLUSTER = 0, RISK_MOMENTS_OUT = 1, RISK_MOMENTS_IN = 2 };

// Whether a's trunk has the widths of the P=1 register chain (P1W).
__host__ __device__ inline bool p1_widths(const ApgArgs& a) {
  return a.HID == P1_HID && a.F <= P1_FMAX && a.OUT == P1_OUT;
}

// Whether the trunk's weights w0, b0, w1, b1, w2, b2 close the consts
// buffer (ops/cuda/consts.py::build_consts), so that the consts before
// them, a.o_w0 floats, are all that P1_GLOBAL copies into shared memory.
inline bool trunk_last(const ApgArgs& a) {
  const int F = a.F, H = a.HID, O = a.OUT;
  return a.o_b0 == a.o_w0 + F * H && a.o_w1 == a.o_b0 + H && a.o_b1 == a.o_w1 + H * H &&
         a.o_w2 == a.o_b1 + H && a.o_b2 == a.o_w2 + H * O && a.n_consts == a.o_b2 + O;
}

// The P=1 form of a launch of a: the one a.step names, or by shape the
// register chain on P1W's widths, else the shared-memory step with the
// weights in shared memory where `smem_fits(P1_SMEM)` (the kernel's block
// within 227 KB), else with the weights in device memory.
template <class Fits>
inline int p1_form(const ApgArgs& a, Fits smem_fits) {
  if (a.step != P1_BY_SHAPE) return a.step;
  if (p1_widths(a)) return P1_CHAIN;
  return smem_fits(P1_SMEM) ? P1_SMEM : P1_GLOBAL;
}

// The P=1 form `step` takes a's trunk: the register chain exactly on P1W's
// widths, the shared-memory step elsewhere (its global form on a buffer
// whose weights come last).
inline bool p1_form_ok(const ApgArgs& a, int step) {
  if (step == P1_CHAIN) return p1_widths(a);
  if (step == P1_SMEM) return !p1_widths(a);
  return step == P1_GLOBAL && !p1_widths(a) && trunk_last(a);
}

// The particle forms' trunk (a.step): P1_SMEM the weights, with their
// transposes for the reverse sweep, in the block's shared-memory copy of the
// consts; P1_GLOBAL the global-weight forms (sweeps.cuh, GW: the weights read
// in place from scenario 0's consts in device memory, only the consts before
// them copied, no transposes; the OPT instantiations only, the options their
// runtime branches), in libraries of their own (apg_solve_gw.cu,
// apg_solve_gw_bf16.cu, cost_oracle_gw.cu), built in parallel. By shape:
// P1_SMEM where the kernel's block fits 227 KB with a's chunk
// (`smem_fits(P1_SMEM)`), else P1_GLOBAL; the wrappers plan the chunk in
// the shared-memory form first and take the global-weight form only where no
// chunk of it fits (ops/cuda/consts.py::plan_particles), so every trunk that
// planned before keeps its form. The two give the same bits.
template <class Fits>
inline int part_form(const ApgArgs& a, Fits smem_fits) {
  if (a.step != P1_BY_SHAPE) return a.step;
  return smem_fits(P1_SMEM) ? P1_SMEM : P1_GLOBAL;
}

// The particle form `step` takes a's buffer: the shared-memory form always,
// the global-weight form on a buffer whose weights come last.
inline bool part_form_ok(const ApgArgs& a, int step) {
  return step == P1_SMEM || (step == P1_GLOBAL && trunk_last(a));
}

// The constraint fields agree with the decision width.
inline bool constr_args_ok(const ApgArgs& a) {
  if (a.sc_kind == CONSTR_PROX) return a.m >= 1 && a.nZ == a.n_u + a.m;
  return (a.sc_kind == CONSTR_NONE || a.sc_kind == CONSTR_PENALTY) && a.m == 0 &&
         a.nZ == a.n_u;
}

// scal block (o_scal): [mass, diff_scale, uerr, u_slew_coeff,
//                       u_slew_constr_coeff, res_mult, risk_lambda]
enum { SC_MASS = 0, SC_DIFF = 1, SC_UERR = 2, SC_SLEW = 3, SC_SLEWC = 4,
       SC_RESM = 5, SC_RISK = 6 };
