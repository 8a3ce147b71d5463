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
// Numerics: fp32 throughout, no fast-math. softplus is
// max(x,0)+log1p(exp(-|x|)) and the sigmoid 1/(1+exp(-x)), as in JAX. The
// Armijo candidate steps use the host's float32(decrease_factor**k) table.

#include <cuda_runtime.h>
#include <math.h>

#include "apg_solve.cuh"

namespace {

constexpr float kG = 9.81f;

struct Smem {
  float *c;                        // copy of the consts buffer
  float *D, *u, *y, *bu, *g, *yp, *gp;   // (H, nZ) each
  float *cand;                     // (K, H, nZ)
  float *xs;                       // (H+1, 13) stashed states of a vg sweep
  float *h0p, *h1p, *h2;           // (H, HID), (H, HID), (H, OUT) stash
  float *xr;                       // (K, 13) candidate row states
  float *feat, *a0, *a1, *a2;      // (K, F), (K, HID), (K, HID), (K, OUT)
  float *jt, *jr;                  // (K,) running stage costs
  float *ct;                       // (13,) reverse-sweep state cotangent
  float *cu;                       // (nZ,) partial control cotangent
  float *c_h2, *c_h1p, *c_h0p, *c_feat;   // (OUT), (HID), (HID), (F)
  float *red;                      // (32,) reduction results
};

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

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // valid in lane 0
}
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
// out = X + 2 u x (u x X + w X)   (bodies.py::_qrotate)
__device__ __forceinline__ void qrot(float w, const float* u, const float* X, float* out) {
  float c[3], t[3], c2[3];
  cross3(u, X, c);
  for (int i = 0; i < 3; ++i) t[i] = c[i] + w * X[i];
  cross3(u, t, c2);
  for (int i = 0; i < 3; ++i) out[i] = X[i] + 2.f * c2[i];
}
// VJP of qrot (bodies.py::_qrotate_bwd): cotangent c_out of out ->
// (c_w, c_u, c_X).
__device__ __forceinline__ void qrot_bwd(float w, const float* u, const float* X,
                                         const float* c_out, float* c_w,
                                         float* c_u, float* c_X) {
  float c[3], t[3], cc2[3], ct[3], tmp[3];
  cross3(u, X, c);
  for (int i = 0; i < 3; ++i) t[i] = c[i] + w * X[i];
  for (int i = 0; i < 3; ++i) cc2[i] = 2.f * c_out[i];
  cross3(t, cc2, c_u);
  cross3(cc2, u, ct);
  cross3(X, ct, tmp);
  for (int i = 0; i < 3; ++i) c_u[i] = c_u[i] + tmp[i];
  cross3(ct, u, tmp);
  for (int i = 0; i < 3; ++i) c_X[i] = tmp[i] + w * ct[i] + c_out[i];
  *c_w = X[0] * ct[0] + X[1] * ct[1] + X[2] * ct[2];
}
// 0.5 * q (x) [0, om]   (bodies.py::_qmul_omega)
__device__ __forceinline__ void qdot(const float* q, const float* om, float* dq) {
  dq[0] = 0.5f * (-q[1] * om[0] - q[2] * om[1] - q[3] * om[2]);
  dq[1] = 0.5f * (q[0] * om[0] + q[2] * om[2] - q[3] * om[1]);
  dq[2] = 0.5f * (q[0] * om[1] - q[1] * om[2] + q[3] * om[0]);
  dq[3] = 0.5f * (q[0] * om[2] + q[1] * om[1] - q[2] * om[0]);
}
// wrench = mix_eff @ u  (4 rows)
__device__ __forceinline__ void wrench4(const ApgArgs& a, const float* mix,
                                        const float* u, float* w) {
  for (int m = 0; m < 4; ++m) {
    float acc = 0.f;
    for (int i = 0; i < a.n_u; ++i) acc += u[i] * mix[m * a.n_u + i];
    w[m] = acc;
  }
}

// Sum of n values produced by f(e), by one warp; lane 0 writes *out.
template <class Fn>
__device__ __forceinline__ void warp_reduce_to(int n, Fn f, float* out) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int e = lane; e < n; e += 32) acc += f(e);
  acc = warp_sum(acc);
  if (lane == 0) *out = acc;
}

// One Euler step plus stage cost for R rows (bodies.py::make_step,
// deterministic). Row r's controls are U[r * ustride + i]; its state is
// read from x[r*13..] and the new state written to xn[r*13..] (x and xn may
// alias). With a stash (R == 1), the trunk pre-activations are recorded.
// Accumulates jt[r] += d_t * track and jr[r] += d_t * res2.
__device__ void fwd_step(const ApgArgs& a, const Smem& s, int R, const float* U,
                         int ustride, const float* x, float* xn, int t,
                         float* st_h0p, float* st_h1p, float* st_h2) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* c = s.c;
  const int F = a.F, HID = a.HID, OUT = a.OUT;

  // features: body-frame velocity, rates, gravity direction, motors
  if (tid < R) {
    const float* xr = x + tid * 13;
    const float qcu[3] = {-xr[7], -xr[8], -xr[9]};
    const float ez[3] = {0.f, 0.f, 1.f};
    float* f = s.feat + tid * F;
    qrot(xr[6], qcu, xr + 3, f);
    f[3] = xr[10]; f[4] = xr[11]; f[5] = xr[12];
    qrot(xr[6], qcu, ez, f + 6);
    for (int i = 0; i < a.n_u; ++i) f[9 + i] = U[tid * ustride + i];
  }
  __syncthreads();
  const float* w0 = c + a.o_w0; const float* b0 = c + a.o_b0;
  for (int idx = tid; idx < R * HID; idx += nt) {
    const int r = idx / HID, j = idx - r * HID;
    const float* f = s.feat + r * F;
    float acc = 0.f;
    for (int i = 0; i < F; ++i) acc += f[i] * w0[i * HID + j];
    const float pre = acc + b0[j];
    s.a0[idx] = pre * sigm(pre);
    if (st_h0p) st_h0p[j] = pre;
  }
  __syncthreads();
  const float* w1 = c + a.o_w1; const float* b1 = c + a.o_b1;
  for (int idx = tid; idx < R * HID; idx += nt) {
    const int r = idx / HID, j = idx - r * HID;
    const float* h = s.a0 + r * HID;
    float acc = 0.f;
    for (int i = 0; i < HID; ++i) acc += h[i] * w1[i * HID + j];
    const float pre = acc + b1[j];
    s.a1[idx] = pre * sigm(pre);
    if (st_h1p) st_h1p[j] = pre;
  }
  __syncthreads();
  const float* w2 = c + a.o_w2; const float* b2 = c + a.o_b2;
  for (int idx = tid; idx < R * OUT; idx += nt) {
    const int r = idx / OUT, o = idx - r * OUT;
    const float* h = s.a1 + r * HID;
    float acc = 0.f;
    for (int i = 0; i < HID; ++i) acc += h[i] * w2[i * OUT + o];
    const float pre = acc + b2[o];
    s.a2[idx] = pre;
    if (st_h2) st_h2[o] = pre;
  }
  __syncthreads();
  if (tid < R) {
    const float* xr = x + tid * 13;
    const float* h = s.a2 + tid * OUT;
    const float* scal = c + a.o_scal;
    const float* in = c + a.o_inertia;
    const float* ws = c + a.o_wstate;
    const float* r = c + a.o_xref + (t + 1) * 13;
    const float dt = c[a.o_ts + t], d_t = c[a.o_disc + t];
    const float mass = scal[SC_MASS], ds = scal[SC_DIFF];
    float p[3], v[3], q[4], om[3];
    for (int i = 0; i < 3; ++i) { p[i] = xr[i]; v[i] = xr[3 + i]; om[i] = xr[10 + i]; }
    for (int i = 0; i < 4; ++i) q[i] = xr[6 + i];

    float res2 = 0.f;
    for (int i = 0; i < 6; ++i) {
      const float sg = softplus(h[6 + i]) * ds;
      res2 += sg * sg;
    }
    float w[4];
    wrench4(a, c + a.o_mix, U + tid * ustride, w);
    const float fb[3] = {h[0], h[1], h[2] - w[0]};
    float rot[3];
    qrot(q[0], q + 1, fb, rot);
    const float acc[3] = {rot[0] / mass, rot[1] / mass, kG + rot[2] / mass};
    float Iom[3], cr[3], dom[3], dq[4];
    for (int i = 0; i < 3; ++i) Iom[i] = in[i] * om[i];
    cross3(om, Iom, cr);
    for (int i = 0; i < 3; ++i) dom[i] = (w[1 + i] + h[3 + i] - cr[i]) / in[i];
    qdot(q, om, dq);

    float p1[3], v1[3], q1[4], om1[3];
    for (int i = 0; i < 3; ++i) {
      p1[i] = p[i] + dt * v[i];
      v1[i] = v[i] + dt * acc[i];
      om1[i] = om[i] + dt * dom[i];
    }
    float nq = 0.f;
    for (int i = 0; i < 4; ++i) { q1[i] = q[i] + dt * dq[i]; nq += q1[i] * q1[i]; }
    nq = sqrtf(nq + 1e-12f);
    for (int i = 0; i < 4; ++i) q1[i] = q1[i] / nq;

    // stage cost at the new state vs the reference row t+1
    const float rw = r[6], rx = r[7], ry = r[8], rz = r[9];
    const float ew = rw * q1[0] + rx * q1[1] + ry * q1[2] + rz * q1[3];
    const float ex = rw * q1[1] - rx * q1[0] - ry * q1[3] + rz * q1[2];
    const float ey = rw * q1[2] + rx * q1[3] - ry * q1[0] - rz * q1[1];
    const float ez = rw * q1[3] - rx * q1[2] + ry * q1[1] - rz * q1[0];
    const float sgn = ew < 0.f ? -1.f : 1.f;
    const float e3[3] = {sgn * ex, sgn * ey, sgn * ez};
    float tp = 0.f, tv = 0.f, tq = 0.f, tw = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float dp = p1[i] - r[i], dv = v1[i] - r[3 + i], dw = om1[i] - r[10 + i];
      tp += ws[i] * dp * dp;
      tv += ws[3 + i] * dv * dv;
      tq += ws[6 + i] * e3[i] * e3[i];
      tw += ws[9 + i] * dw * dw;
    }
    const float track = tp + tv + tq + tw;

    float* o = xn + tid * 13;
    for (int i = 0; i < 3; ++i) { o[i] = p1[i]; o[3 + i] = v1[i]; o[10 + i] = om1[i]; }
    for (int i = 0; i < 4; ++i) o[6 + i] = q1[i];
    s.jt[tid] += d_t * track;
    s.jr[tid] += d_t * res2;
  }
  __syncthreads();
}

// One reverse step (bodies.py::manual_bwd_step, B = 1) at horizon index t,
// reading the stash; updates the state cotangent s.ct and writes the
// dynamics part of the control gradient into s.g[t*nZ ..].
__device__ void bwd_step(const ApgArgs& a, const Smem& s, const float* U, int t) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const float* c = s.c;
  const int F = a.F, HID = a.HID, OUT = a.OUT;
  const float* st = s.xs + t * 13;
  const float* x1 = s.xs + (t + 1) * 13;
  const float* h2 = s.h2 + t * OUT;
  const float* u = U + t * a.nZ;
  const float* scal = c + a.o_scal;
  const float* in = c + a.o_inertia;
  const float* mix = c + a.o_mix;
  const float dt = c[a.o_ts + t], d_t = c[a.o_disc + t];

  // ---- part 1 (thread 0): stage cost, sigma, renormalize, EM, dynamics
  if (tid == 0) {
    const float* ws = c + a.o_wstate;
    const float* r = c + a.o_xref + (t + 1) * 13;
    const float cT = d_t;
    const float cR = d_t * scal[SC_RESM];
    float* ct = s.ct;
    float cp1[3], cv1[3], cq1[4], com1[3];
    for (int i = 0; i < 3; ++i) {
      cp1[i] = ct[i] + cT * 2.f * ws[i] * (x1[i] - r[i]);
      cv1[i] = ct[3 + i] + cT * 2.f * ws[3 + i] * (x1[3 + i] - r[3 + i]);
      com1[i] = ct[10 + i] + cT * 2.f * ws[9 + i] * (x1[10 + i] - r[10 + i]);
    }
    const float rw = r[6], rx = r[7], ry = r[8], rz = r[9];
    const float* q1 = x1 + 6;
    const float ew = rw * q1[0] + rx * q1[1] + ry * q1[2] + rz * q1[3];
    const float ex = rw * q1[1] - rx * q1[0] - ry * q1[3] + rz * q1[2];
    const float ey = rw * q1[2] + rx * q1[3] - ry * q1[0] - rz * q1[1];
    const float ez = rw * q1[3] - rx * q1[2] + ry * q1[1] - rz * q1[0];
    const float sg = ew < 0.f ? -1.f : 1.f;
    const float c_ex = sg * cT * 2.f * ws[6] * (sg * ex);
    const float c_ey = sg * cT * 2.f * ws[7] * (sg * ey);
    const float c_ez = sg * cT * 2.f * ws[8] * (sg * ez);
    cq1[0] = ct[6] + (-rx * c_ex - ry * c_ey - rz * c_ez);
    cq1[1] = ct[7] + (rw * c_ex - rz * c_ey + ry * c_ez);
    cq1[2] = ct[8] + (rz * c_ex + rw * c_ey - rx * c_ez);
    cq1[3] = ct[9] + (-ry * c_ex + rx * c_ey + rw * c_ez);

    // sigma / res2
    const float dsc = scal[SC_DIFF];
    for (int i = 0; i < 6; ++i) {
      const float hs = h2[6 + i];
      const float sig6 = softplus(hs) * dsc;
      const float c_sig6 = cR * 2.f * sig6;
      s.c_h2[6 + i] = c_sig6 * sigm(hs) * dsc;
    }

    // quaternion renormalize
    const float* q = st + 6;
    const float* om = st + 10;
    float dq[4], q1r[4];
    qdot(q, om, dq);
    float nrm2 = 0.f;
    for (int i = 0; i < 4; ++i) { q1r[i] = q[i] + dt * dq[i]; nrm2 += q1r[i] * q1r[i]; }
    nrm2 = nrm2 + 1e-12f;
    const float nrm = sqrtf(nrm2);
    float dotc = 0.f;
    for (int i = 0; i < 4; ++i) dotc += cq1[i] * q1r[i];
    const float coef = dotc / (nrm2 * nrm);
    float c_q1r[4];
    for (int i = 0; i < 4; ++i) c_q1r[i] = cq1[i] / nrm - q1r[i] * coef;

    // EM update
    float cp[3], cv[3], c_acc[3], com[3], c_dom[3], cq[4], c_dq[4];
    for (int i = 0; i < 3; ++i) {
      cp[i] = cp1[i];
      cv[i] = cv1[i] + dt * cp1[i];
      c_acc[i] = dt * cv1[i];
      com[i] = com1[i];
      c_dom[i] = dt * com1[i];
    }
    for (int i = 0; i < 4; ++i) { cq[i] = c_q1r[i]; c_dq[i] = dt * c_q1r[i]; }
    const float ox = om[0], oy = om[1], oz = om[2];
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    cq[0] += 0.5f * (c_dq[1] * ox + c_dq[2] * oy + c_dq[3] * oz);
    cq[1] += 0.5f * (-c_dq[0] * ox - c_dq[2] * oz + c_dq[3] * oy);
    cq[2] += 0.5f * (-c_dq[0] * oy + c_dq[1] * oz - c_dq[3] * ox);
    cq[3] += 0.5f * (-c_dq[0] * oz - c_dq[1] * oy + c_dq[2] * ox);
    com[0] += 0.5f * (-c_dq[0] * qx + c_dq[1] * qw + c_dq[2] * qz - c_dq[3] * qy);
    com[1] += 0.5f * (-c_dq[0] * qy - c_dq[1] * qz + c_dq[2] * qw + c_dq[3] * qx);
    com[2] += 0.5f * (-c_dq[0] * qz + c_dq[1] * qy - c_dq[2] * qx + c_dq[3] * qw);

    // domega = (tau + res36 - om x (I om)) / I
    float c_tau[3], c_crs[3], Iom[3], t1[3], t2[3];
    for (int i = 0; i < 3; ++i) {
      c_tau[i] = c_dom[i] / in[i];
      s.c_h2[3 + i] = c_dom[i] / in[i];
      c_crs[i] = -c_dom[i] / in[i];
      Iom[i] = in[i] * om[i];
    }
    cross3(Iom, c_crs, t1);
    cross3(c_crs, om, t2);
    for (int i = 0; i < 3; ++i) com[i] = (com[i] + t1[i]) + in[i] * t2[i];

    // acc = G e_z + qrotate(q, f_body) / mass
    float w[4];
    wrench4(a, mix, u, w);
    const float fb[3] = {h2[0], h2[1], h2[2] - w[0]};
    float c_rot[3], c_wq, c_uq[3], c_fb[3];
    for (int i = 0; i < 3; ++i) c_rot[i] = c_acc[i] / scal[SC_MASS];
    qrot_bwd(qw, q + 1, fb, c_rot, &c_wq, c_uq, c_fb);
    cq[0] += c_wq;
    for (int i = 0; i < 3; ++i) cq[1 + i] += c_uq[i];
    for (int i = 0; i < 3; ++i) s.c_h2[i] = c_fb[i];
    const float c_wr[4] = {-c_fb[2], c_tau[0], c_tau[1], c_tau[2]};
    for (int i = 0; i < a.n_u; ++i) {
      float acc = 0.f;
      for (int m = 0; m < 4; ++m) acc += c_wr[m] * mix[m * a.n_u + i];
      s.cu[i] = acc;
    }
    for (int i = 0; i < 3; ++i) { ct[i] = cp[i]; ct[3 + i] = cv[i]; ct[10 + i] = com[i]; }
    for (int i = 0; i < 4; ++i) ct[6 + i] = cq[i];
  }
  __syncthreads();

  // ---- trunk backward on the stashed pre-activations
  const float* w2 = c + a.o_w2;
  const float* h1p = s.h1p + t * HID;
  for (int j = tid; j < HID; j += blockDim.x) {
    float acc = 0.f;
    for (int o = 0; o < OUT; ++o) acc += s.c_h2[o] * w2[j * OUT + o];
    const float s1 = sigm(h1p[j]);
    s.c_h1p[j] = acc * (s1 + h1p[j] * s1 * (1.f - s1));
  }
  __syncthreads();
  const float* w1 = c + a.o_w1;
  const float* h0p = s.h0p + t * HID;
  for (int i = warp; i < HID; i += nw) {       // one warp per row of w1
    float acc = 0.f;
    for (int j = lane; j < HID; j += 32) acc += w1[i * HID + j] * s.c_h1p[j];
    acc = warp_sum(acc);
    if (lane == 0) {
      const float s0 = sigm(h0p[i]);
      s.c_h0p[i] = acc * (s0 + h0p[i] * s0 * (1.f - s0));
    }
  }
  __syncthreads();
  const float* w0 = c + a.o_w0;
  for (int i = warp; i < F; i += nw) {          // one warp per row of w0
    float acc = 0.f;
    for (int j = lane; j < HID; j += 32) acc += w0[i * HID + j] * s.c_h0p[j];
    acc = warp_sum(acc);
    if (lane == 0) s.c_feat[i] = acc;
  }
  __syncthreads();

  // ---- part 2 (thread 0): features back to the state and the controls
  if (tid == 0) {
    float* ct = s.ct;
    const float* cf = s.c_feat;
    const float* q = st + 6;
    const float* v = st + 3;
    for (int i = 0; i < 3; ++i) ct[10 + i] += cf[3 + i];
    const float qcu[3] = {-q[1], -q[2], -q[3]};
    const float ez[3] = {0.f, 0.f, 1.f};
    float c_wv, c_uv[3], c_v[3], c_wg, c_ug[3], c_e[3];
    qrot_bwd(q[0], qcu, v, cf, &c_wv, c_uv, c_v);
    qrot_bwd(q[0], qcu, ez, cf + 6, &c_wg, c_ug, c_e);
    for (int i = 0; i < 3; ++i) ct[3 + i] += c_v[i];
    ct[6] += c_wv + c_wg;
    for (int i = 0; i < 3; ++i) ct[7 + i] += -(c_uv[i] + c_ug[i]);
    for (int i = 0; i < a.n_u; ++i) s.g[t * a.nZ + i] = s.cu[i] + cf[9 + i];
  }
  __syncthreads();
}

// Closed-form gradient of the control-only cost terms at (t, i)
// (bodies.py::vg_sweep, :598-628).
__device__ float ctrl_grad(const ApgArgs& a, const float* c, const float* U, int t, int i) {
  const float* scal = c + a.o_scal;
  const float d_t = c[a.o_disc + t], dt = c[a.o_ts + t];
  const float ut = U[t * a.nZ + i];
  const float up = t == 0 ? c[a.o_uprev + i] : U[(t - 1) * a.nZ + i];
  const float sl_t = ut - up;
  float gc = 2.f * scal[SC_UERR] * d_t * (ut - c[a.o_uref + i]) + 2.f * scal[SC_SLEW] * sl_t;
  const bool has_next = t + 1 < a.H;
  const float sl_n = has_next ? U[(t + 1) * a.nZ + i] - ut : 0.f;
  gc = gc - 2.f * scal[SC_SLEW] * sl_n;
  if (a.has_slew) {
    const float lo = c[a.o_slo + i], hi = c[a.o_shi + i];
    const float rate_t = sl_t / dt;
    const float g_rate_t = (2.f * fmaxf(rate_t - hi, 0.f) - 2.f * fmaxf(lo - rate_t, 0.f)) / dt;
    const float dt_n = c[a.o_ts + (has_next ? t + 1 : a.H - 1)];
    const float rate_n = sl_n / dt_n;
    const float g_rate_n = (2.f * fmaxf(rate_n - hi, 0.f) - 2.f * fmaxf(lo - rate_n, 0.f)) / dt_n;
    gc = gc + scal[SC_SLEWC] * (g_rate_t - (has_next ? g_rate_n : 0.f));
  }
  return gc;
}

// Elementwise control-cost terms of an (H, nZ) block at e = t*nZ + i:
// uerr part, slew part and slew-rate violation (bodies.py::control_cost).
struct CtrlTerms { float u, sl, viol; };
__device__ __forceinline__ CtrlTerms ctrl_terms(const ApgArgs& a, const float* c,
                                                const float* U, int e) {
  const int t = e / a.nZ, i = e - t * a.nZ;
  CtrlTerms r;
  const float du = U[e] - c[a.o_uref + i];
  r.u = c[a.o_disc + t] * du * du;
  const float up = t == 0 ? c[a.o_uprev + i] : U[e - a.nZ];
  const float sl = U[e] - up;
  r.sl = sl * sl;
  r.viol = 0.f;
  if (a.has_slew) {
    const float rate = sl / c[a.o_ts + t];
    const float ov = fmaxf(rate - c[a.o_shi + i], 0.f);
    const float un = fmaxf(c[a.o_slo + i] - rate, 0.f);
    r.viol = ov * ov + un * un;
  }
  return r;
}

// Value and gradient of the iterate U (bodies.py::vg_sweep): checkpointed
// forward sweep into the stash, manual reverse sweep, closed-form control
// gradients. Gradient lands in s.g, the value in S.fval.
__device__ void vg(const ApgArgs& a, const Smem& s, Scal& S, const float* U) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* c = s.c;
  const int HZ = a.H * a.nZ;
  if (tid < 13) { s.xs[tid] = c[a.o_x0 + tid]; s.ct[tid] = 0.f; }
  if (tid == 0) { s.jt[0] = 0.f; s.jr[0] = 0.f; }
  __syncthreads();
  for (int t = 0; t < a.H; ++t)
    fwd_step(a, s, 1, U + t * a.nZ, 0, s.xs + t * 13, s.xs + (t + 1) * 13, t,
             s.h0p + t * a.HID, s.h1p + t * a.HID, s.h2 + t * a.OUT);
  for (int t = a.H - 1; t >= 0; --t) bwd_step(a, s, U, t);
  for (int e = tid; e < HZ; e += blockDim.x) {
    const int t = e / a.nZ, i = e - t * a.nZ;
    s.g[e] = s.g[e] + ctrl_grad(a, c, U, t, i);
  }
  if (warp == 0) warp_reduce_to(HZ, [&](int e) { return ctrl_terms(a, c, U, e).u; }, s.red + 0);
  if (warp == 1) warp_reduce_to(HZ, [&](int e) { return ctrl_terms(a, c, U, e).sl; }, s.red + 1);
  if (warp == 2) warp_reduce_to(HZ, [&](int e) { return ctrl_terms(a, c, U, e).viol; }, s.red + 2);
  __syncthreads();
  if (tid == 0) {
    const float* scal = c + a.o_scal;
    float jc = scal[SC_UERR] * s.red[0] + scal[SC_SLEW] * s.red[1];
    if (a.has_slew) jc = jc + scal[SC_SLEWC] * s.red[2];
    S.fval = s.jt[0] + scal[SC_RESM] * s.jr[0] + jc;
  }
  __syncthreads();
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

  vg(a, s, S, s.u);
  for (int e = tid; e < HZ; e += nt) s.gp[e] = s.g[e];
  if (tid == 0) { S.f0 = S.fval; S.f_u = S.fval; S.best_f = S.fval; }
  __syncthreads();

  while (S.k < S.kmax && !S.done) {
    vg(a, s, S, s.y);                       // f_y in S.fval, grad in s.g

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
  vg(a, s, S, s.bu);
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
