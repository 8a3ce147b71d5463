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
// Scope: deterministic P=1, no state constraints, no slack, no particle
// chunks (the wrapper refuses the rest). The step, sweep and cost device
// code is sweeps.cuh, shared with the whole-solve kernel (apg_solve.cu), so
// the two paths compute the same numbers.
//
// What bounds them on this card: latency. A step is a (9+n_u)->64->64->12
// MLP plus rigid-body math, serial over the H steps; one plan is ~0.2 MFLOP
// forward. What the design does about it: each block copies the 24.9 KB
// consts buffer into shared memory once and keeps every intermediate
// there; value_batch runs ORACLE_TILE candidates as rows of one batched
// fwd_step per block, with ceil(K / ORACLE_TILE) blocks in parallel, so
// any K runs in the time of one tile (the TPU package sends K > 128 to XLA
// only because of its VMEM; here a tile's 41 KB fits the default 48 KB).
// value_and_grad and trajectory are one block each.
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

// Carve one block's dynamic shared memory for `kind` with R rows; returns
// the number of floats used. Fields a kernel does not use stay null.
__host__ __device__ inline int layout(const ApgArgs& a, int kind, int R,
                                      Smem* s, float* base) {
  const int HZ = a.H * a.nZ;
  int o = 0;
  auto take = [&](float** p, int n) {
    if (s) *p = base + o;
    o += n;
  };
  Smem d = {};
  Smem* t = s ? s : &d;
  take(&t->c, a.n_consts);
  take(&t->cand, R * HZ);
  take(&t->xr, R * 13);
  take(&t->feat, R * a.F);
  take(&t->a0, R * a.HID); take(&t->a1, R * a.HID);
  take(&t->a2, R * a.OUT);
  take(&t->jt, R); take(&t->jr, R);
  take(&t->red, 32);
  if (kind != ORACLE_VALUE_BATCH) take(&t->xs, (a.H + 1) * 13);
  if (kind == ORACLE_VALUE_AND_GRAD) {
    take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
    take(&t->h2, a.H * a.OUT);
    take(&t->g, HZ);
    take(&t->ct, 13); take(&t->cu, a.nZ);
    take(&t->c_h2, a.OUT); take(&t->c_h1p, a.HID); take(&t->c_h0p, a.HID);
    take(&t->c_feat, a.F);
  }
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

__global__ void __launch_bounds__(ORACLE_NTHREADS)
value_batch_kernel(ApgArgs a, int K, int tile, const float* __restrict__ consts,
                   const float* __restrict__ U, float* __restrict__ out) {
  extern __shared__ float smem[];
  Smem s = {};
  layout(a, ORACLE_VALUE_BATCH, tile, &s, smem);
  const int HZ = a.H * a.nZ, nZ = a.nZ;
  const int k0 = blockIdx.x * tile;
  const int R = min(tile, K - k0);
  const int tid = threadIdx.x, warp = tid >> 5, nw = blockDim.x >> 5;
  const float* c = s.c;
  load_block(a, s, R, consts, U + (size_t)k0 * HZ);

  for (int t = 0; t < a.H; ++t)
    fwd_step(a, s, R, s.cand + t * nZ, HZ, s.xr, s.xr, t, nullptr, nullptr, nullptr);

  // control-only cost per row, one warp per row
  const float* scal = c + a.o_scal;
  for (int r = warp; r < R; r += nw) {
    const float* Ur = s.cand + r * HZ;
    warp_reduce_to(HZ, [&](int e) {
      const CtrlTerms ct = ctrl_terms(a, c, Ur, e);
      float cc = scal[SC_UERR] * ct.u + scal[SC_SLEW] * ct.sl;
      if (a.has_slew) cc = cc + scal[SC_SLEWC] * ct.viol;
      return cc;
    }, s.red + r);
  }
  __syncthreads();
  if (tid < R) out[k0 + tid] = (s.jt[tid] + scal[SC_RESM] * s.jr[tid]) + s.red[tid];
}

__global__ void __launch_bounds__(ORACLE_NTHREADS)
trajectory_kernel(ApgArgs a, const float* __restrict__ consts,
                  const float* __restrict__ u, float* __restrict__ x_out) {
  extern __shared__ float smem[];
  Smem s = {};
  layout(a, ORACLE_TRAJECTORY, 1, &s, smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  load_block(a, s, 1, consts, u);
  if (tid < 13) s.xs[tid] = s.xr[tid];
  __syncthreads();
  for (int t = 0; t < a.H; ++t)
    fwd_step(a, s, 1, s.cand + t * a.nZ, 0, s.xs + t * 13, s.xs + (t + 1) * 13, t,
             nullptr, nullptr, nullptr);
  for (int e = tid; e < (a.H + 1) * 13; e += nt) x_out[e] = s.xs[e];
}

__global__ void __launch_bounds__(ORACLE_NTHREADS)
value_and_grad_kernel(ApgArgs a, const float* __restrict__ consts,
                      const float* __restrict__ u, float* __restrict__ val,
                      float* __restrict__ grad) {
  extern __shared__ float smem[];
  __shared__ float fval;
  Smem s = {};
  layout(a, ORACLE_VALUE_AND_GRAD, 1, &s, smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  load_block(a, s, 1, consts, u);
  vg(a, s, &fval, s.cand);
  for (int e = tid; e < a.H * a.nZ; e += nt) grad[e] = s.g[e];
  if (tid == 0) *val = fval;
}

int tile_rows(int K) { return K < ORACLE_TILE ? K : ORACLE_TILE; }

int dyn_bytes(const ApgArgs& a, int kind, int R) {
  return layout(a, kind, R, nullptr, nullptr) * (int)sizeof(float);
}

bool args_ok(const ApgArgs* a) {
  return a->nZ == a->n_u && a->OUT == 12 && a->F == 9 + a->n_u && a->H >= 1;
}

}  // namespace

extern "C" {

int cost_oracle_args_size() { return (int)sizeof(ApgArgs); }

const char* cost_oracle_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory one block of each kernel needs (dynamic + static).
int value_batch_smem_bytes(const ApgArgs* a, int K) {
  return dyn_bytes(*a, ORACLE_VALUE_BATCH, tile_rows(K));
}
int trajectory_smem_bytes(const ApgArgs* a) {
  return dyn_bytes(*a, ORACLE_TRAJECTORY, 1);
}
int value_and_grad_smem_bytes(const ApgArgs* a) {
  return dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1) + (int)sizeof(float);
}

// Launchers: one launch on `stream` each, returning cudaGetLastError()
// after it (cudaErrorInvalidValue for arguments the kernels do not take).
// U is (K, H, nZ), u (H, nZ); outputs are (K,), (H+1, 13), () and (H, nZ).
int value_batch_launch(const ApgArgs* a, int K, const void* consts,
                       const void* U, void* out, void* stream) {
  if (!args_ok(a) || K < 1 || value_batch_smem_bytes(a, K) > ORACLE_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int tile = tile_rows(K);
  const int blocks = (K + tile - 1) / tile;
  value_batch_kernel<<<blocks, ORACLE_NTHREADS, dyn_bytes(*a, ORACLE_VALUE_BATCH, tile),
                       (cudaStream_t)stream>>>(
      *a, K, tile, (const float*)consts, (const float*)U, (float*)out);
  return (int)cudaGetLastError();
}

int trajectory_launch(const ApgArgs* a, const void* consts, const void* u,
                      void* x_out, void* stream) {
  if (!args_ok(a) || trajectory_smem_bytes(a) > ORACLE_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  trajectory_kernel<<<1, ORACLE_NTHREADS, dyn_bytes(*a, ORACLE_TRAJECTORY, 1),
                      (cudaStream_t)stream>>>(
      *a, (const float*)consts, (const float*)u, (float*)x_out);
  return (int)cudaGetLastError();
}

int value_and_grad_launch(const ApgArgs* a, const void* consts, const void* u,
                          void* val, void* grad, void* stream) {
  if (!args_ok(a) || value_and_grad_smem_bytes(a) > ORACLE_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  value_and_grad_kernel<<<1, ORACLE_NTHREADS, dyn_bytes(*a, ORACLE_VALUE_AND_GRAD, 1),
                          (cudaStream_t)stream>>>(
      *a, (const float*)consts, (const float*)u, (float*)val, (float*)grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
