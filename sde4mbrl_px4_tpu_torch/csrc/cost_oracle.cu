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
// intermediate there; the P=1 value_and_grad runs the whole-solve kernel's
// P=1 sweep (sweeps.cuh::vg: the trunk in registers, two barriers per
// step, HID = 64 and F <= 16 only). At P=1 value_batch runs ORACLE_TILE candidates as
// rows of one batched fwd_step per block, with ceil(K / ORACLE_TILE) blocks
// in parallel, so any K runs in the time of one tile (the TPU package sends
// K > 128 to XLA only because of its VMEM; here a tile's 41 KB fits the
// default 48 KB). With particles each candidate is a block of its own that
// sweeps its P particles Pc rows at a time (K blocks in parallel), and
// value_and_grad spreads its chunks over a thread-block cluster, one block
// per SM, as the whole-solve kernel does (sweeps.cuh::vg_part: each block
// sweeps chunks rank, rank + C, ..., and every block sums all chunks'
// partials in chunk order through distributed shared memory; rank 0 writes
// the value and the gradient); both take dynamic shared memory above 48 KB
// (set once per library load by cost_oracle_init), and the wrapper picks
// the largest divisor Pc of P whose layouts fit. trajectory is one block. The constraint terms add
// per-row scalar work to each step and no memory traffic; at nZ > n_u a
// value_batch tile shrinks below 16 rows where its wider rows would pass
// 48 KB (16 rows of nZ = 10 still fit, at 48.7 KB).
//
// Control flow is block-uniform and every __syncthreads() is reached by all
// threads of the block.

#include <cuda_runtime.h>

#include "apg_solve.cuh"
#include "cost_oracle.cuh"
#include "sweeps.cuh"

namespace {

static_assert(ORACLE_TILE <= 32, "one red slot per tile row");
static_assert(ORACLE_TILE <= ORACLE_NTHREADS, "fwd_step: one thread per row");
static_assert(ORACLE_NTHREADS == 4 * P1_HID, "P=1 value_and_grad: 4 threads per hidden unit");

// Carve one block's dynamic shared memory for `kind` with R candidate rows
// of controls; returns the number of floats used. part: the particle form
// (R*Pc step rows per pass, a Pc-row state stash and reverse sweep in
// value_and_grad). Fields a kernel does not use stay null. The P=1
// value_and_grad layout starts every buffer on 16 bytes (its float4 reads).
__host__ __device__ inline int layout(const ApgArgs& a, int kind, int R, bool part,
                                      Smem* s, float* base) {
  const int HZ = a.H * a.nZ;
  const int rows = part ? R * a.Pc : R;       // step rows per pass
  const int B = part ? a.Pc : 1;              // value_and_grad rows per pass
  int o = 0;
  const bool align = kind == ORACLE_VALUE_AND_GRAD && !part;
  auto take = [&](float** p, int n) {
    if (align) o = (o + 3) & ~3;
    if (s) *p = base + o;
    o += n;
  };
  Smem d = {};
  Smem* t = s ? s : &d;
  take(&t->c, a.n_consts);
  take(&t->cand, R * HZ);
  take(&t->xr, rows * 13);
  take(&t->feat, rows * a.F);
  take(&t->a0, rows * a.HID); take(&t->a1, rows * a.HID);
  take(&t->a2, rows * a.OUT);
  take(&t->jt, rows); take(&t->jr, rows);
  take(&t->red, 32);
  if (kind != ORACLE_VALUE_BATCH) take(&t->xs, (a.H + 1) * B * 13);
  if (kind == ORACLE_VALUE_AND_GRAD) {
    if (part) {
      take(&t->p0, B * a.HID); take(&t->p1, B * a.HID);
    } else {
      take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
      take(&t->h2, a.H * a.OUT); take(&t->wr, a.H * 4);
    }
    take(&t->g, HZ);
    if (part) take(&t->ct, B * 13);              // P=1: the row's cotangents in
    take(&t->cu, B * a.nZ);                      // registers (p1_reverse)
    if (part) take(&t->c_h2, B * a.OUT);
    take(&t->c_h1p, B * a.HID); take(&t->c_h0p, B * a.HID);
    if (part) take(&t->c_feat, B * a.F);
    if (part) {
      take(&t->w0t, a.F * a.HID); take(&t->w1t, a.HID * a.HID);
      take(&t->w2t, a.OUT * a.HID);
    }
  }
  if (part) take(&t->cacc, 2 * R);
  // the chunk partials of a value_and_grad block (gradient and 2 costs)
  if (part && kind == ORACLE_VALUE_AND_GRAD) take(&t->pg, a.chunks_per_block * (HZ + 2));
  return o;
}

// Copy the consts and R rows of controls (row r of the block at U + r*HZ)
// into shared memory, start each row at x0 with zero running costs.
__device__ void load_block(const ApgArgs& a, const Smem& s, int R,
                           const float* __restrict__ consts,
                           const float* __restrict__ U) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < a.n_consts; i += nt) s.c[i] = consts[i];
  for (int e = tid; e < R * a.H * a.nZ; e += nt) s.cand[e] = U[e];
  for (int e = tid; e < R * 13; e += nt) s.xr[e] = consts[a.o_x0 + e % 13];
  if (tid < R) { s.jt[tid] = 0.f; s.jr[tid] = 0.f; }
  __syncthreads();
}

template <bool PART, int SC>
__global__ void __launch_bounds__(PART ? ORACLE_NTHREADS_PART : ORACLE_NTHREADS)
value_batch_kernel(int K, int tile, ApgArgs a, const float* __restrict__ consts,
                   const float* __restrict__ U, const float* __restrict__ noise,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  Smem s = {};
  layout(a, ORACLE_VALUE_BATCH, tile, PART, &s, smem);
  const int HZ = a.H * a.nZ, nZ = a.nZ;
  const int k0 = blockIdx.x * tile;
  const int R = min(tile, K - k0);
  const int tid = threadIdx.x, warp = tid >> 5, nw = blockDim.x >> 5;
  const float* c = s.c;
  load_block(a, s, R, consts, U + (size_t)k0 * HZ);

  if constexpr (PART) {
    cand_part<SC>(a, s, R, noise);
  } else {
    for (int t = 0; t < a.H; ++t)
      fwd_step<false, SC>(a, s, R, s.cand + t * nZ, HZ, 1, nullptr, s.xr, s.xr, t);
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
  if (tid < R) out[k0 + tid] = (cost_t[tid] + scal[SC_RESM] * cost_r[tid]) + s.red[tid];
}

__global__ void __launch_bounds__(ORACLE_NTHREADS)
trajectory_kernel(ApgArgs a, const float* __restrict__ consts,
                  const float* __restrict__ u, float* __restrict__ x_out) {
  extern __shared__ float smem[];
  Smem s = {};
  layout(a, ORACLE_TRAJECTORY, 1, false, &s, smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  load_block(a, s, 1, consts, u);
  if (tid < 13) s.xs[tid] = s.xr[tid];
  __syncthreads();
  for (int t = 0; t < a.H; ++t)
    fwd_step<false, CONSTR_NONE>(a, s, 1, s.cand + t * a.nZ, 0, 1, nullptr, s.xs + t * 13,
                                 s.xs + (t + 1) * 13, t);
  for (int e = tid; e < (a.H + 1) * 13; e += nt) x_out[e] = s.xs[e];
}

template <bool PART, int SC>
__global__ void __launch_bounds__(PART ? ORACLE_NTHREADS_PART : ORACLE_NTHREADS)
value_and_grad_kernel(ApgArgs a, const float* __restrict__ consts,
                      const float* __restrict__ u, const float* __restrict__ noise,
                      float* __restrict__ val, float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float fval;
  Smem s = {};
  layout(a, ORACLE_VALUE_AND_GRAD, 1, PART, &s, smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  load_block(a, s, 1, consts, u);
  int rank = 0;                       // the block's rank in its cluster
  if constexpr (PART) {
    rank = (int)cg::this_cluster().block_rank();
    transpose_weights(a, s);
    vg_part<SC>(a, s, &fval, s.cand, noise);
  } else {
    vg<SC>(a, s, load_p1_weights(a, s.c), &fval, s.cand);
  }
  if (rank != 0) return;
  for (int e = tid; e < a.H * a.nZ; e += nt) grad[e] = s.g[e];
  if (tid == 0) *val = fval;
}

int dyn_bytes(const ApgArgs& a, int kind, int R, bool part) {
  return layout(a, kind, R, part, nullptr, nullptr) * (int)sizeof(float);
}

// Candidate rows per value_batch block: a tile at P=1 (up to ORACLE_TILE,
// fewer where wide decision rows would pass the 48 KB budget), one
// candidate (and its Pc particle rows per pass) with particles.
int tile_rows(const ApgArgs& a, int K) {
  if (a.has_noise) return 1;
  int tile = K < ORACLE_TILE ? K : ORACLE_TILE;
  while (tile > 1 && dyn_bytes(a, ORACLE_VALUE_BATCH, tile, false) > ORACLE_SMEM_LIMIT)
    --tile;
  return tile;
}

int smem_limit(const ApgArgs& a) {
  return a.has_noise ? ORACLE_SMEM_LIMIT_PARTICLES : ORACLE_SMEM_LIMIT;
}

bool args_ok(const ApgArgs* a) {
  return constr_args_ok(*a) && a->OUT == 12 && a->F == 9 + a->n_u && a->H >= 1;
}

// One launch of an instantiation; the tables below pick it by
// [has_noise][sc_kind].
template <bool PART, int SC>
void launch_value_batch(const ApgArgs& a, int K, int tile, int blocks, size_t dyn,
                        cudaStream_t st, const float* consts, const float* U,
                        const float* noise, float* out) {
  value_batch_kernel<PART, SC><<<blocks, PART ? ORACLE_NTHREADS_PART : ORACLE_NTHREADS,
                                 dyn, st>>>(K, tile, a, consts, U, noise, out);
}
using ValueBatchFn = void (*)(const ApgArgs&, int, int, int, size_t, cudaStream_t,
                              const float*, const float*, const float*, float*);
const ValueBatchFn kValueBatch[2][3] = {
    {launch_value_batch<false, CONSTR_NONE>, launch_value_batch<false, CONSTR_PENALTY>,
     launch_value_batch<false, CONSTR_PROX>},
    {launch_value_batch<true, CONSTR_NONE>, launch_value_batch<true, CONSTR_PENALTY>,
     launch_value_batch<true, CONSTR_PROX>}};

// P=1 one block; particles one cluster of a.cluster blocks
// (cudaLaunchKernelEx, whose error a cluster the card cannot schedule
// returns).
template <bool PART, int SC>
cudaError_t launch_value_and_grad(const ApgArgs& a, size_t dyn, cudaStream_t st,
                                  const float* consts, const float* u, const float* noise,
                                  float* val, float* grad) {
  if constexpr (PART) {
    ClusterLaunch l(a.cluster, ORACLE_NTHREADS_PART, dyn, st);
    return cudaLaunchKernelEx(&l.cfg, value_and_grad_kernel<true, SC>, a, consts, u, noise,
                              val, grad);
  } else {
    value_and_grad_kernel<false, SC><<<1, ORACLE_NTHREADS, dyn, st>>>(a, consts, u, noise,
                                                                     val, grad);
    return cudaSuccess;
  }
}
using ValueAndGradFn = cudaError_t (*)(const ApgArgs&, size_t, cudaStream_t, const float*,
                                       const float*, const float*, float*, float*);
const ValueAndGradFn kValueAndGrad[2][3] = {
    {launch_value_and_grad<false, CONSTR_NONE>, launch_value_and_grad<false, CONSTR_PENALTY>,
     launch_value_and_grad<false, CONSTR_PROX>},
    {launch_value_and_grad<true, CONSTR_NONE>, launch_value_and_grad<true, CONSTR_PENALTY>,
     launch_value_and_grad<true, CONSTR_PROX>}};

// The particle fields and the noise block, when the kernel reads them.
bool particles_ok(const ApgArgs* a, const void* noise) {
  if (!a->has_noise) return a->P == 1 && a->Pc == 1 && a->n_chunks == 1;
  return noise != nullptr && a->Pc >= 1 && a->n_chunks >= 1 &&
         a->Pc * a->n_chunks == a->P;
}

// The largest cluster of each particle value_and_grad form [sc_kind]
// (cost_oracle_init; 0 before it).
int g_cmax[3] = {0, 0, 0};

}  // namespace

extern "C" {

int cost_oracle_args_size() { return (int)sizeof(ApgArgs); }

const char* cost_oracle_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Let the particle forms take dynamic shared memory above 48 KB (the
// deterministic ones stay inside the default). Called once when the library
// is loaded; returns a cudaError_t.
int cost_oracle_init() {
  const cudaError_t errs[] = {
      allow_large_smem(value_batch_kernel<true, CONSTR_NONE>),
      allow_large_smem(value_batch_kernel<true, CONSTR_PENALTY>),
      allow_large_smem(value_batch_kernel<true, CONSTR_PROX>),
      allow_large_smem(value_and_grad_kernel<true, CONSTR_NONE>),
      allow_large_smem(value_and_grad_kernel<true, CONSTR_PENALTY>),
      allow_large_smem(value_and_grad_kernel<true, CONSTR_PROX>),
      cluster_max(value_and_grad_kernel<true, CONSTR_NONE>, ORACLE_NTHREADS_PART, &g_cmax[0]),
      cluster_max(value_and_grad_kernel<true, CONSTR_PENALTY>, ORACLE_NTHREADS_PART,
                  &g_cmax[1]),
      cluster_max(value_and_grad_kernel<true, CONSTR_PROX>, ORACLE_NTHREADS_PART,
                  &g_cmax[2])};
  for (const cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return 0;
}

// The largest cluster of the particle value_and_grad of sc_kind.
int value_and_grad_cluster_max(int sc_kind) {
  return sc_kind >= CONSTR_NONE && sc_kind <= CONSTR_PROX ? g_cmax[sc_kind] : 0;
}

// cudaOccupancyMaxActiveClusters of the particle value_and_grad for a's
// dimensions and cluster size, into *n; returns a cudaError_t.
int value_and_grad_max_active_clusters(const ApgArgs* a, int* n) {
  using Fn = void (*)(ApgArgs, const float*, const float*, const float*, float*, float*);
  const Fn fns[3] = {value_and_grad_kernel<true, CONSTR_NONE>,
                     value_and_grad_kernel<true, CONSTR_PENALTY>,
                     value_and_grad_kernel<true, CONSTR_PROX>};
  if (!a->has_noise || a->sc_kind < CONSTR_NONE || a->sc_kind > CONSTR_PROX || a->cluster < 1)
    return (int)cudaErrorInvalidValue;
  return (int)max_active_clusters(fns[a->sc_kind], a->cluster, ORACLE_NTHREADS_PART,
                                  (size_t)dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1, true), n);
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

// Launchers: one launch on `stream` each, returning cudaGetLastError()
// after it (cudaErrorInvalidValue for arguments the kernels do not take).
// U is (K, H, nZ), u (H, nZ), noise the (H, P, 13) Brownian block (read
// only when a->has_noise; may be null otherwise); outputs are (K,),
// (H+1, 13), () and (H, nZ). The P=1 value_and_grad takes the trunk
// widths of the register layout only (HID = P1_HID, F <= P1_FMAX); the
// particle one a's cluster plan of its chunks, and returns the cluster
// launch's own error where the card cannot schedule it.
int value_batch_launch(const ApgArgs* a, int K, const void* consts,
                       const void* U, const void* noise, void* out, void* stream) {
  if (!args_ok(a) || !particles_ok(a, noise) || K < 1 ||
      value_batch_smem_bytes(a, K) > smem_limit(*a))
    return (int)cudaErrorInvalidValue;
  const int tile = tile_rows(*a, K);
  const int blocks = (K + tile - 1) / tile;
  const size_t dyn = value_batch_smem_bytes(a, K);
  kValueBatch[a->has_noise != 0][a->sc_kind](
      *a, K, tile, blocks, dyn, (cudaStream_t)stream, (const float*)consts,
      (const float*)U, (const float*)noise, (float*)out);
  return (int)cudaGetLastError();
}

int trajectory_launch(const ApgArgs* a, const void* consts, const void* u,
                      void* x_out, void* stream) {
  if (!args_ok(a) || trajectory_smem_bytes(a) > ORACLE_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  trajectory_kernel<<<1, ORACLE_NTHREADS, trajectory_smem_bytes(a),
                      (cudaStream_t)stream>>>(
      *a, (const float*)consts, (const float*)u, (float*)x_out);
  return (int)cudaGetLastError();
}

int value_and_grad_launch(const ApgArgs* a, const void* consts, const void* u,
                          const void* noise, void* val, void* grad, void* stream) {
  if (!args_ok(a) || !particles_ok(a, noise) ||
      (!a->has_noise && (a->HID != P1_HID || a->F > P1_FMAX)) ||
      (a->has_noise && !cluster_args_ok(*a, g_cmax[a->sc_kind])) ||
      value_and_grad_smem_bytes(a) > smem_limit(*a))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1, a->has_noise != 0);
  return launch_error(kValueAndGrad[a->has_noise != 0][a->sc_kind](
      *a, dyn, (cudaStream_t)stream, (const float*)consts, (const float*)u,
      (const float*)noise, (float*)val, (float*)grad));
}

}  // extern "C"
