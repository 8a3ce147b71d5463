// Whole-solve APG kernel for Hopper (sm_90a): one receding-horizon MPC
// solve per thread block.
//
// Replaces the TPU kernel sde4mbrl_px4_tpu/ops/pallas/apg_kernel.py::
// pallas_apg_solve (pallas_call at :420, body _kernel :163-391) together
// with the sde4mbrl_px4_tpu/ops/pallas/bodies.py functions it runs:
// make_step with want_acts (K1), manual_bwd_step/_qrotate_bwd (K2),
// vg_sweep on its flight branch (K3), candidate_rollout/run_candidates at
// P=1 (K4), the control cost inlined at apg_kernel.py:239-262 (K5), and the
// build_consts layout (K7, ops/cuda/consts.py). Scope: deterministic P=1
// solves without state constraints, slack or particle chunks.
//
// What bounds it on this card: latency, not FLOPs or bytes. One APG
// iteration is about 1.6 MFLOP (a forward and a reverse sweep of one row
// plus a forward sweep of K candidate rows, each step a (9+n_u)->64->64->12
// MLP), serial over the H steps of the horizon and over up to max_iter
// iterations; the whole working set is ~45 KB. What the design does about
// it: everything (weights, consts, iterates, the state and activation
// stash) lives in shared memory for the whole solve, so the loop never
// touches device memory; the hidden units of each layer are spread over
// the threads, the K linesearch candidates are rows of one batched
// rollout, the transposed matvecs of the reverse sweep are warp-per-row
// reductions, and the loop exits on the device. No allocation, no host
// round trip, one launch per solve.
//
// Control flow is block-uniform: every loop decision (done, accepted step,
// restart) is computed by thread 0 into shared memory, followed by
// __syncthreads(), and only then read by all threads. Every
// __syncthreads() below is reached by all threads.
//
// Numerics: fp32 throughout, no fast-math. The step, sweep and cost device
// code lives in sweeps.cuh, shared with the cost-oracle kernels. The Armijo
// candidate steps use the host's float32(decrease_factor**k) table.

#include <cuda_runtime.h>
#include <math.h>

#include "apg_solve.cuh"
#include "sweeps.cuh"

namespace {

struct Scal {
  int k, k_m, no_imp, done, kmax, ok, improved, restart;
  float f_u, t, best_f, sum_t, sum_ls, f0, fval, t0, t_acc, beta;
};

// Carve the dynamic shared memory; returns the number of floats used.
__host__ __device__ inline int layout(const ApgArgs& a, Smem* s, float* base) {
  const int HZ = a.H * a.nZ;
  int o = 0;
  auto take = [&](float** p, int n) {
    if (s) *p = base + o;
    o += n;
  };
  Smem d;
  Smem* t = s ? s : &d;
  take(&t->c, a.n_consts);
  take(&t->D, HZ); take(&t->u, HZ); take(&t->y, HZ); take(&t->bu, HZ);
  take(&t->g, HZ); take(&t->yp, HZ); take(&t->gp, HZ);
  take(&t->cand, a.K * HZ);
  take(&t->xs, (a.H + 1) * 13);
  take(&t->h0p, a.H * a.HID); take(&t->h1p, a.H * a.HID);
  take(&t->h2, a.H * a.OUT);
  take(&t->xr, a.K * 13);
  take(&t->feat, a.K * a.F);
  take(&t->a0, a.K * a.HID); take(&t->a1, a.K * a.HID);
  take(&t->a2, a.K * a.OUT);
  take(&t->jt, a.K); take(&t->jr, a.K);
  take(&t->ct, 13); take(&t->cu, a.nZ);
  take(&t->c_h2, a.OUT); take(&t->c_h1p, a.HID); take(&t->c_h0p, a.HID);
  take(&t->c_feat, a.F);
  take(&t->red, 32);
  return o;
}

__global__ void __launch_bounds__(APG_NTHREADS)
apg_solve_kernel(ApgArgs a, const float* __restrict__ consts,
                 const float* __restrict__ u_init, const float* __restrict__ t0p,
                 const float* __restrict__ precond, float* __restrict__ yk,
                 float* __restrict__ stats, float* __restrict__ x_evol) {
  extern __shared__ float smem[];
  __shared__ Scal S;
  Smem s;
  layout(a, &s, smem);
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, nw = nt >> 5;
  const int HZ = a.H * a.nZ, K = a.K, nZ = a.nZ;
  const float* c = s.c;

  for (int i = tid; i < a.n_consts; i += nt) s.c[i] = consts[i];
  __syncthreads();
  for (int e = tid; e < HZ; e += nt) {
    const int i = e % nZ;
    const float u0 = clampf(u_init[e], c[a.o_lb + i], c[a.o_ub + i]);
    s.u[e] = u0; s.y[e] = u0; s.bu[e] = u0; s.yp[e] = u0;
    s.D[e] = a.has_pre ? precond[e] : 1.f;
  }
  if (tid == 0) {
    S.k = 0; S.k_m = 0; S.no_imp = 0; S.done = 0;
    S.kmax = a.has_budget ? min(a.max_iter, max(a.budget, 1)) : a.max_iter;
    S.t = *t0p;
    S.sum_t = 0.f; S.sum_ls = 0.f;
  }
  __syncthreads();

  vg(a, s, &S.fval, s.u);
  for (int e = tid; e < HZ; e += nt) s.gp[e] = s.g[e];
  if (tid == 0) { S.f0 = S.fval; S.f_u = S.fval; S.best_f = S.fval; }
  __syncthreads();

  while (S.k < S.kmax && !S.done) {
    vg(a, s, &S.fval, s.y);                       // f_y in S.fval, grad in s.g

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
    for (int e = tid; e < K * 13; e += nt) s.xr[e] = c[a.o_x0 + e % 13];
    if (tid < K) { s.jt[tid] = 0.f; s.jr[tid] = 0.f; }
    __syncthreads();
    for (int t = 0; t < a.H; ++t)
      fwd_step(a, s, K, s.cand + t * nZ, HZ, s.xr, s.xr, t, nullptr, nullptr, nullptr);

    // ---- per-candidate control cost, <g, d>, <d, D^-1 d>
    for (int j = warp; j < 3 * K; j += nw) {
      const int k = j / 3, kind = j - 3 * k;
      const float* Uk = s.cand + k * HZ;
      if (kind == 0) {
        const float* scal = c + a.o_scal;
        warp_reduce_to(HZ, [&](int e) {
          const CtrlTerms ct = ctrl_terms(a, c, Uk, e);
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
        const float fk = (s.jt[ki] + res_mult * s.jr[ki]) + s.red[3 * ki];
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

  // ---- exit gradient at the best iterate; its forward states are x_evol
  vg(a, s, &S.fval, s.bu);
  if (warp == 0) warp_reduce_to(HZ, [&](int e) { return s.g[e] * s.g[e]; }, s.red + 0);
  for (int e = tid; e < HZ; e += nt) yk[e] = s.bu[e];
  for (int e = tid; e < (a.H + 1) * 13; e += nt) x_evol[e] = s.xs[e];
  __syncthreads();
  if (tid == 0) {
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
}

}  // namespace

extern "C" {

int apg_args_size() { return (int)sizeof(ApgArgs); }

// Shared memory the kernel needs for these dimensions (dynamic + static).
int apg_smem_bytes(const ApgArgs* a) {
  return layout(*a, nullptr, nullptr) * (int)sizeof(float) + (int)sizeof(Scal);
}

const char* apg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch one solve on `stream`. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
int apg_solve_launch(const ApgArgs* a, const void* consts, const void* u_init,
                     const void* t0, const void* precond, void* yk, void* stats,
                     void* x_evol, void* stream) {
  if (a->K < 1 || a->K > APG_MAXK || a->nZ != a->n_u || a->OUT != 12 ||
      a->F != 9 + a->n_u || apg_smem_bytes(a) > APG_SMEM_LIMIT ||
      (a->has_pre && precond == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = (size_t)layout(*a, nullptr, nullptr) * sizeof(float);
  apg_solve_kernel<<<1, APG_NTHREADS, dyn, (cudaStream_t)stream>>>(
      *a, (const float*)consts, (const float*)u_init, (const float*)t0,
      (const float*)precond, (float*)yk, (float*)stats, (float*)x_evol);
  return (int)cudaGetLastError();
}

}  // extern "C"
