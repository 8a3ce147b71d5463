// Device code shared by the port's kernels: the whole-solve APG kernel
// (apg_solve.cu) and the cost-oracle kernels (cost_oracle.cu). One source of
// truth, as sde4mbrl_px4_tpu/ops/pallas/bodies.py is for the TPU kernels:
//
//   - scalar helpers: sigm, softplus, warp_sum, qrot/qrot_bwd, qdot,
//     wrench4, warp_reduce_to;
//   - trunk / fwd_step: the network and one Euler(-Maruyama) step plus
//     stage cost for R rows (bodies.py::make_step); fwd_step<false> is the
//     deterministic P=1 form, fwd_step<true> the particle form with the
//     Brownian term (bodies.py:159-165);
//   - em_step: the Euler(-Maruyama) step and stage cost of one row, on
//     shared memory (fwd_step) or on registers (the P=1 forms);
//   - bwd_dyn / bwd_feat: the scalar halves of one reverse step of a row
//     (bodies.py::manual_bwd_step); bwd_rows: one reverse step of a chunk of
//     particle rows (the noise branch that the TPU kernel traces with
//     jax.vjp, bodies.py:587-596);
//   - the P=1 forms (P1W, p1_rollout, p1_reverse, vg): the trunk in
//     registers, split-K layer-1 products, the row's scalar step in the 32
//     lanes of its warp, two block barriers per step; on trunks of other
//     widths the P=1 wide step (vg_wide, cand_wide: the same structure over
//     a runtime width, layer 1 split over the block's warps, the weights in
//     shared or device memory, wt) and, for value_batch and trajectory, the
//     shared-memory step fwd_step<false>;
//   - ctrl_grad / ctrl_terms: the control-only cost terms and their
//     closed-form gradient (bodies.py::control_cost, vg_sweep :598-628);
//   - vg / vg_part: value and gradient of one plan (bodies.py::vg_sweep),
//     deterministic (P=1) and over P particles in chunks (K11, :638-661);
//   - cand_part: K candidates x P particles in chunks, the particle mean
//     per candidate (bodies.py::candidate_rollout/run_candidates, :700-765);
//   - cluster_chunk_sum: the chunk partials of a thread-block cluster
//     summed in chunk order through distributed shared memory; with the
//     spread (spread_chunk_sum) through slots in device memory;
//   - the particle options (a.risk, the starts): the risk-sensitive
//     reduction mean + lambda * std of the particles' discounted totals
//     (sde4mbrl_px4_tpu/cost/cost.py:213-229) and a start per particle
//     (ops/rollout.py:163-169), which the TPU package runs on XLA only.
//
// Every function works on shared-memory scratch described by Smem; each
// kernel carves its own layout and sets the fields the functions it calls
// read (the P=1 forms read s.a0, s.a1 and s.c_h1p as float4: their layouts
// align every buffer to 16 bytes). Functions that contain __syncthreads()
// are called by every thread of the block.
//
// Particles: the Brownian block is (H, P, 13) in device memory, horizon-
// major, so the rows of chunk ch at step t are contiguous at
// noise + (t*P + ch*Pc)*13. A chunk of Pc particles is swept as Pc rows
// (K*Pc for the candidates, particle-major: row i = p*K + k); costs are
// means over the chunk's rows, then means over chunks (mean of chunk means,
// as the TPU kernel reduces), and the particle-form loops run rows over the
// threads, so R may exceed blockDim.
//
// The particle forms of every kernel spread the chunks over a thread-block
// cluster (ApgArgs::cluster blocks, one per SM): block `rank` sweeps chunks
// rank, rank + cluster, ..., and keeps each chunk's partials (its share of
// the gradient, g_u / n_chunks, and of the costs) apart. After a cluster
// barrier every block sums the partials of all chunks in chunk order
// 0 .. n_chunks-1, read from their blocks' shared memory
// (cluster_chunk_sum): the summation order of a one-block serial chunk loop
// and of the TPU kernel's fori_loop (bodies.py:650-657), so every cluster
// size gives the same bits, and every block holds the same reduced values.
// The whole solve and value_and_grad launch one cluster; value_batch a grid
// of K clusters, one per candidate (cand_part with K = 1).
//
// The spread (SPREAD, a template parameter of vg_part and cand_part that the
// global-weight forms of the whole solve and of value_and_grad take;
// ApgArgs::groups): what bounds those forms is the trunk's FLOPs on the SMs
// they get, then the weights' reads from L2 (they read every weight in
// place, apg_solve.cuh part_form), and one cluster gives a scenario at most
// 16 SMs. With groups > 1 a scenario runs on N = groups * cluster blocks of
// a cooperative grid, blocks b*N .. b*N + N-1, block j sweeping chunks j,
// j + N, ...: no block keeps the trunk in its shared memory, so nothing ties
// a scenario's chunks to one cluster. Each block writes its chunks'
// partials to their slots in device memory (the launch's scratch,
// apg_solve.cuh spread_floats), a barrier over the scenario's blocks alone
// (an arrival counter, spread_barrier; the cooperative launch makes every
// block resident, or is refused) follows, and every block sums the slots in
// chunk order 0 .. n_chunks-1 (spread_chunk_sum): the loop of
// cluster_chunk_sum on another memory, so every groups and cluster give the
// bits of one block, and every block holds the same sums and takes the same
// decisions. groups = 1 is the one cluster above (the spread forms then read
// the same sums through distributed shared memory).
//
// The particle options are a template parameter OPT of the particle sweeps
// (vg_part, cand_part, bwd_rows) and of the kernels' particle forms: the
// forms without them (OPT = false) compile to the code they had before the
// options existed, and a launch with risk or starts takes the OPT = true
// form, whose branches are runtime (a.risk, a null starts pointer).
//
// Risk (a.risk, lambda at scal[SC_RISK]): each row's discounted total
// tot = jt + res_mult * jr is kept in s.tot for the block's chunks; two more
// ordered cluster sums give each plan's mean m of the totals and then their
// centred second moment var (centred first, as the original: the one-pass
// sum of squares cancels when the spread is small against the mean); the
// tracking mean becomes mean + lambda * sqrt(var + 1e-12). The gradient
// weighs row p's share by w_p = 1 + lambda * (tot_p - m) / sqrt(var +
// 1e-12) (times the mean's 1/P, as without risk): the reverse of a row is
// linear in its seeds (tracking, uncertainty and constraint terms alike),
// so bwd_rows runs it unweighted and scales the row's control cotangent by
// w_p where it sums the rows, which leaves the reverse step's registers as
// they were. w needs every particle's forward before any reverse, so
// vg_part forwards all of a block's chunks before any reverse; a block
// holding more than one chunk runs the forward of every chunk but its last
// again into the stash before that chunk's reverse (the stash holds one
// chunk). Across the blocks of particles of a sharded solve (RM, the risk
// mode, a template parameter of vg_part and cand_part; apg_solve.cuh
// RISK_*): cand_part's RISK_MOMENTS_OUT leaves each candidate's centred
// second moment about its own mean in s.cacc[3K + k] in place of adding
// lambda * std, so that value_batch writes the risk-free cost and both
// moments out; vg_part's RISK_MOMENTS_IN takes the mean m and std of the
// totals over all particles in s.red[6], s.red[7] (the kernel puts them
// there), so a row's weight is ready after its own forward and each chunk
// runs forward then reverse as without risk. The default RISK_IN_CLUSTER
// compiles to the code the forms had before the modes existed.
// Starts: an optional (P, 13) array of per-particle initial states
// (the wrapper makes it from x0, the std and the draws z0); row p of chunk
// ch starts at start ch * Pc + p, every candidate of a particle at its
// particle's start; without it every row starts at x0.
//
// State constraints (the state_constr block; bodies.py:188-206 and their
// reverse, which the TPU kernel gets by tracing jax.vjp, apg_kernel.py:
// 140-142): a template parameter SC of fwd_step, bwd_dyn and every sweep
// above them (CONSTR_NONE, CONSTR_PENALTY, CONSTR_PROX), so the
// unconstrained instantiations compile to the code they had without it.
// constr_cost adds the terms to a row's stage cost at its new state, in the
// TPU kernel's order; constr_bwd adds their cotangents to the post-step
// state before the renormalisation backward (and, in the proximal form,
// the slack columns' gradient). In the proximal form a decision row is
// nZ = n_u + m wide: the trunk, the wrench and the control terms read its
// first n_u columns, the slack targets are columns n_u.. . The terms are
// scalar per-row arithmetic on constants in shared memory: latency on the
// step's serial chain, no memory traffic.
//
// Reduced matmul precision (ApgArgs::bf16; the JAX package's
// matmul_precision "default", which its TPU runs as bf16-input, fp32-
// accumulate dots on XLA, sde4mbrl_px4_tpu/models/sde_model.py:123-146):
// the operands of the trunk's three products are rounded to bf16 where they
// are stored, not inside the product loops. Forward: each layer's input (the
// features, motor commands included, and the swish outputs s.a0, s.a1) and
// the weights w0, w1, w2, rounded once in the block's shared-memory copy of
// the consts (the buffer in device memory stays fp32: trajectory reads it).
// Reverse (bwd_rows): the transposed products' operands, the pre-activation
// cotangents s.c_h2, s.c_h1p, s.c_h0p and the (rounded) transposed weights,
// as JAX's transpose rule keeps the forward's precision. Not rounded: the
// biases, the stashed pre-activations the swish derivative reads, the
// wrench, sigma and every cost term. A product of two bf16 values is exact
// in fp32, so the sums are the fp32 sums of the rounded operands. The
// rounding is a template parameter BF of the sweeps (trunk, fwd_step,
// bwd_rows, vg_part, cand_part, p1_rollout): the kernels' bf16
// instantiations take BF = true, and every form without it compiles to the
// code it had before the parameter existed.
//
// Trunks wider than a block's shared memory takes (apg_solve.cuh, part_form;
// past 144 units on the iris configs at P=512): the particle forms' global-
// weight forms (GW, a template parameter of trunk, rows_gemm, bwd_rows,
// vg_part and cand_part) read the trunk's weights and biases in place from
// device memory (s.wg: scenario 0's consts, L2-resident; wt, through the
// read-only path, rounded to bf16 where read in the bf16 forms), keep no
// transposes, and copy only the consts before the trunk into shared memory.
// Every sum takes the products of the shared-memory forms in their order,
// so the two forms give the same bits wherever both run the same chunk and
// cluster.
//
// Numerics: fp32 throughout, no fast-math. softplus is
// max(x,0)+log1p(exp(-|x|)) and the sigmoid 1/(1+exp(-x)), as in JAX.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "apg_solve.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kG = 9.81f;

// The spread's state, in the block's shared memory (spread_init): this
// scenario's slots and arrival counter in the launch's scratch (groups > 1),
// and the number of chunk sums the block has taken, which picks the region a
// sum writes and the count its barrier waits for.
struct Spread {
  float* slots;
  unsigned* arrive;
  unsigned nsum;
};

// Shared-memory scratch. R is the number of rows a fwd_step sweeps at once
// (the whole-solve kernel's K linesearch candidates, a value_batch tile).
struct Smem {
  float *c;                        // copy of the consts buffer
  float *D, *u, *y, *bu, *g, *yp, *gp;   // (H, nZ) each (whole solve; g in vg)
  float *cand;                     // (R, H, nZ) rows of controls
  float *xs;                       // (H+1, Pc, 13) stashed states of a vg sweep
  float *h0p, *h1p, *h2;           // (H, HID), (H, HID), (H, OUT) stash (P=1)
  float *xr;                       // (R, 13) row states
  float *feat, *a0, *a1, *a2;      // (R, F), (R, HID), (R, HID), (R, OUT)
  float *jt, *jr;                  // (R,) running stage costs
  float *p0, *p1;                  // (Pc, HID) each: recomputed pre-activations
  // reverse sweep, one set per row (Pc rows in the particle form)
  float *ct;                       // (13,) state cotangent
  float *cu;                       // (nZ,) partial control cotangent
  float *c_h2, *c_h1p, *c_h0p, *c_feat;   // (OUT), (HID), (HID), (F)
  float *cacc;                     // (2K,) particle means per candidate:
                                   // tracking [0, K), sigma [K, 2K); with
                                   // risk (3K,): totals [2K, 3K), and the
                                   // tracking mean carries lambda * std
                                   // (value_batch (4K,): moments out, the
                                   // centred second moments [3K, 4K))
  float *tot;                      // (chunks_per_block, K*Pc) with risk: the
                                   // rows' discounted totals, then (vg_part)
                                   // their gradient weights
  float *w0t, *w1t, *w2t;          // (HID, F), (HID, HID), (OUT, HID):
                                   // transposed weights (particle reverse;
                                   // the P=1 wide step w2t alone)
  float *pp;                       // (kSlices, R, HID) layer 1's slice sums
                                   // (the P=1 wide step)
  const float* wg;                 // the particle forms with the weights in
                                   // device memory (GW): the consts holding
                                   // the trunk the sweeps read (scenario 0's)
  float *red;                      // (32,) reduction results
  float *pg;                       // (chunks_per_block, H*nZ + 2) a block's vg
                                   // chunk partials: gradient, tracking, sigma
                                   // (+ the totals' mean with risk)
  float *pk;                       // (chunks_per_block, 2K) its candidate ones
                                   // ((.., 3K) with risk)
  float *wr;                       // (H, 4) wrench of the vg row per step (P=1)
  struct Spread* sp;               // the spread forms' slots and barrier (shared memory)
  long long *prof;                 // (PH_N + 1,) phase cycles (apg_solve_prof_launch)
};

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

// v rounded to bf16 (to nearest, ties to even: torch's and JAX's casts) and
// back to fp32.
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// An operand of a trunk product as a sweep stores it: rounded to bf16 in
// the bf16-trunk instantiations (BF; header, reduced matmul precision).
template <bool BF>
__device__ __forceinline__ float mm_in(float v) {
  if constexpr (BF) return bf16_rn(v);
  else return v;
}
// Round the trunk weights w0, w1, w2 of a block's consts copy c to bf16 in
// place (every thread a share; the caller puts barriers around it).
__device__ void round_trunk_weights(const ApgArgs& a, float* c) {
  const int n0 = a.F * a.HID, n1 = a.HID * a.HID, n2 = a.HID * a.OUT;
  for (int e = threadIdx.x; e < n0 + n1 + n2; e += blockDim.x) {
    float* w = e < n0 ? c + a.o_w0 + e
               : e < n0 + n1 ? c + a.o_w1 + (e - n0) : c + a.o_w2 + (e - n0 - n1);
    *w = bf16_rn(*w);
  }
}
// x[id] of a 13-float register array at a runtime id, as a select chain (a
// runtime index would move the array to local memory).
__device__ __forceinline__ float pick13(const float* x, int id) {
  float v = x[0];
#pragma unroll
  for (int i = 1; i < 13; ++i) v = id == i ? x[i] : v;
  return v;
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

// The P=1 forms' row controls in registers: u[min(i, n_u-1)] for the
// P1_FMAX - 9 slots, read unconditionally (no branch guards the reads); the
// users mask the slots past n_u.
__device__ __forceinline__ void load_controls(const ApgArgs& a, const float* u, float* uu) {
#pragma unroll
  for (int i = 0; i < P1_FMAX - 9; ++i) uu[i] = u[min(i, a.n_u - 1)];
}

// wrench4 on load_controls' registers, in wrench4's order.
__device__ __forceinline__ void wrench4_reg(const ApgArgs& a, const float* mix,
                                            const float* uu, float* w) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < P1_FMAX - 9; ++i) {
      const float t = fmaf(uu[i], mix[m * a.n_u + min(i, a.n_u - 1)], acc);
      acc = i < a.n_u ? t : acc;
    }
    w[m] = acc;
  }
}

// wrench4 over all n_u controls of u (the wide step's forms past P1_FMAX
// inputs), in wrench4_reg's order: the same sums where both run.
__device__ __forceinline__ void wrench4_all(const ApgArgs& a, const float* mix,
                                            const float* u, float* w) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float acc = 0.f;
    for (int i = 0; i < a.n_u; ++i) acc = fmaf(u[i], mix[m * a.n_u + i], acc);
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

// A trunk weight: from the block's shared-memory copy of the consts, or
// (GW: the P=1 form P1_GLOBAL, the particle forms' global-weight
// forms) from device memory through the read-only
// path, rounded to bf16 there in the bf16 forms (BF: the shared copy holds
// them rounded already, round_trunk_weights).
template <bool GW, bool BF = false>
__device__ __forceinline__ float wt(const float* w) {
  if constexpr (GW) return mm_in<BF>(__ldg(w));
  else return *w;
}

// The row stride of the hidden activations s.a0 and s.a1 in the tiled
// candidate step: HID + 1, so rows a few apart fall in different
// shared-memory banks when a warp reads them.
__host__ __device__ __forceinline__ int tiled_ld(const ApgArgs& a) { return a.HID + 1; }

// epi(r, n, A[r] . W[:, n]) for r < R, n < N: A is (R, Kd) at row stride
// lda in shared memory, W (Kd, N) row-major, read through wt<GW, BF> (in
// shared memory, or GW in device memory). Each thread takes a tile
// of TR rows and TJ columns (columns jt + NJ*c, so a warp reads consecutive
// columns of W, and a row of A at one address), holding its TR x TJ sums in
// registers: one load of A and one of W feed TJ and TR products. Each sum
// runs over k = 0 .. Kd-1 in order from 0.f, as a thread per output does,
// so the result has its bits.
template <int TR, int TJ, bool GW, bool BF, class Epi>
__device__ __forceinline__ void tile_gemm(int R, int N, int Kd, const float* A, int lda,
                                          const float* W, Epi epi) {
  const int NJ = (N + TJ - 1) / TJ, NR = (R + TR - 1) / TR;
  for (int t = threadIdx.x; t < NR * NJ; t += blockDim.x) {
    const int jt = t % NJ, r0 = (t / NJ) * TR;
    const float* ar[TR];
    int col[TJ];
#pragma unroll
    for (int i = 0; i < TR; ++i) ar[i] = A + min(r0 + i, R - 1) * lda;
#pragma unroll
    for (int c = 0; c < TJ; ++c) col[c] = min(jt + NJ * c, N - 1);
    float acc[TR][TJ];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TJ; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < Kd; ++k) {
      const float* w = W + k * N;
      float wv[TJ];
#pragma unroll
      for (int c = 0; c < TJ; ++c) wv[c] = wt<GW, BF>(w + col[c]);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float av = ar[i][k];
#pragma unroll
        for (int c = 0; c < TJ; ++c) acc[i][c] += av * wv[c];
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TJ; ++c)
        if (r0 + i < R && jt + NJ * c < N) epi(r0 + i, jt + NJ * c, acc[i][c]);
  }
}

// tile_gemm with the tile that keeps the block's threads busy: 4 x 4 where
// there are 16 outputs per thread, 2 x 2 where there are 2, else one output
// per thread.
template <bool GW, bool BF, class Epi>
__device__ __forceinline__ void rows_gemm(int R, int N, int Kd, const float* A, int lda,
                                          const float* W, Epi epi) {
  const int outs = R * N, nt = blockDim.x;
  if (outs >= 16 * nt) tile_gemm<4, 4, GW, BF>(R, N, Kd, A, lda, W, epi);
  else if (outs >= 2 * nt) tile_gemm<2, 2, GW, BF>(R, N, Kd, A, lda, W, epi);
  else tile_gemm<1, 1, GW, BF>(R, N, Kd, A, lda, W, epi);
}

// The network for R rows: features (body-frame velocity, rates, gravity
// direction, motors), the two swish layers and the output layer into
// s.feat, s.a0, s.a1, s.a2. Row r's state is x[r*13..]. With PART = false
// (the P=1 shared-memory step: trunks outside the register layout of P1W)
// row r is thread r < R and its controls are
// U[r*ustride ..]; with PART = true rows run over the threads,
// row r's controls are U[(r % K)*ustride ..], and a stash (bwd_rows) records
// the R rows' hidden pre-activations (idx = r*HID + j). TILED (the
// candidate rows of cand_part): the three products as
// register tiles (rows_gemm), s.a0 and s.a1 at row stride tiled_ld; the
// same sums in the same order. BF: the products' inputs stored rounded to
// bf16 (mm_in; the weights are the caller's, rounded in s.c, or GW rounded
// where read). GW (the P=1 form P1_GLOBAL and the particle forms' global-
// weight forms): the weights (and biases) at their offsets from wb, in
// device memory (wt), read in the order and at the indices of the shared
// copy, so both give the same sums. DOT2 (trajectory's P=1 step): the
// hidden and output layers' sums over the HID inputs as compensated dot
// products (Ogita, Rump and Oishi's Dot2): each product's rounding error
// (fmaf) and each addition's (TwoSum) carried in a second sum added last,
// as accurate as one sum in twice the precision, rounded to float.
template <bool PART, bool TILED = false, bool BF = false, bool GW = false,
          bool DOT2 = false>
__device__ void trunk(const ApgArgs& a, const Smem& s, int R, const float* U,
                      int ustride, int K, const float* x, float* st_h0p,
                      float* st_h1p, const float* wb = nullptr) {
  static_assert(!DOT2 || (!PART && !TILED), "the compensated sums are the P=1 step's");
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* c = GW ? wb : s.c;
  const int F = a.F, HID = a.HID, OUT = a.OUT;

  auto features = [&](int r) {
    const float* xr = x + r * 13;
    const float qcu[3] = {-xr[7], -xr[8], -xr[9]};
    const float ez[3] = {0.f, 0.f, 1.f};
    float* f = s.feat + r * F;
    qrot(xr[6], qcu, xr + 3, f);
    f[3] = xr[10]; f[4] = xr[11]; f[5] = xr[12];
    qrot(xr[6], qcu, ez, f + 6);
    const float* ur = PART ? U + (r % K) * ustride : U + r * ustride;
    for (int i = 0; i < a.n_u; ++i) f[9 + i] = ur[i];
    if constexpr (BF)
      for (int i = 0; i < F; ++i) f[i] = bf16_rn(f[i]);
  };
  if constexpr (PART) {
    for (int r = tid; r < R; r += nt) features(r);
  } else if (tid < R) {
    features(tid);
  }
  __syncthreads();
  const float* w0 = c + a.o_w0; const float* b0 = c + a.o_b0;
  if constexpr (TILED) {
    const int ld = tiled_ld(a);
    const float* w1 = c + a.o_w1; const float* b1 = c + a.o_b1;
    const float* w2 = c + a.o_w2; const float* b2 = c + a.o_b2;
    rows_gemm<GW, BF>(R, HID, F, s.feat, F, w0, [&](int r, int j, float acc) {
      const float pre = acc + wt<GW>(b0 + j);
      s.a0[r * ld + j] = mm_in<BF>(pre * sigm(pre));
      if (st_h0p) st_h0p[r * HID + j] = pre;
    });
    __syncthreads();
    rows_gemm<GW, BF>(R, HID, HID, s.a0, ld, w1, [&](int r, int j, float acc) {
      const float pre = acc + wt<GW>(b1 + j);
      s.a1[r * ld + j] = mm_in<BF>(pre * sigm(pre));
      if (st_h1p) st_h1p[r * HID + j] = pre;
    });
    __syncthreads();
    rows_gemm<GW, BF>(R, OUT, HID, s.a1, ld, w2, [&](int r, int o, float acc) {
      s.a2[r * OUT + o] = acc + wt<GW>(b2 + o);
    });
    __syncthreads();
    return;
  }
  for (int idx = tid; idx < R * HID; idx += nt) {
    const int r = idx / HID, j = idx - r * HID;
    const float* f = s.feat + r * F;
    float acc = 0.f;
    for (int i = 0; i < F; ++i) acc += f[i] * wt<GW, BF>(w0 + i * HID + j);
    const float pre = acc + wt<GW>(b0 + j);
    s.a0[idx] = mm_in<BF>(pre * sigm(pre));
    if (st_h0p) st_h0p[idx] = pre;
  }
  __syncthreads();
  const float* w1 = c + a.o_w1; const float* b1 = c + a.o_b1;
  // DOT2: sum_i h[i] * w[i * ld] over i < HID, compensated; the _rn
  // intrinsics keep the compiler from fusing a product into a sum
  auto dot2 = [&](const float* h, const float* w, int ld) {
    float sum = 0.f, err = 0.f;
    for (int i = 0; i < HID; ++i) {
      const float x = h[i], y = wt<GW, BF>(w + i * ld);
      const float p = __fmul_rn(x, y), t = __fadd_rn(sum, p), z = __fsub_rn(t, sum);
      err += (__fsub_rn(sum, __fsub_rn(t, z)) + __fsub_rn(p, z)) + fmaf(x, y, -p);
      sum = t;
    }
    return sum + err;
  };
  for (int idx = tid; idx < R * HID; idx += nt) {
    const int r = idx / HID, j = idx - r * HID;
    const float* h = s.a0 + r * HID;
    float acc = 0.f;
    if constexpr (DOT2) acc = dot2(h, w1 + j, HID);
    else
      for (int i = 0; i < HID; ++i) acc += h[i] * wt<GW, BF>(w1 + i * HID + j);
    const float pre = acc + wt<GW>(b1 + j);
    s.a1[idx] = mm_in<BF>(pre * sigm(pre));
    if (st_h1p) st_h1p[idx] = pre;
  }
  __syncthreads();
  const float* w2 = c + a.o_w2; const float* b2 = c + a.o_b2;
  for (int idx = tid; idx < R * OUT; idx += nt) {
    const int r = idx / OUT, o = idx - r * OUT;
    const float* h = s.a1 + r * HID;
    float acc = 0.f;
    if constexpr (DOT2) acc = dot2(h, w2 + o, OUT);
    else
      for (int i = 0; i < HID; ++i) acc += h[i] * wt<GW, BF>(w2 + i * OUT + o);
    const float pre = acc + wt<GW>(b2 + o);
    s.a2[idx] = pre;
  }
  __syncthreads();
}

// The state-constraint terms of one row's stage cost (bodies.py:188-206),
// added to its tracking cost `track` at the new state xn (13, shared
// memory) in the TPU kernel's order. Proximal: track + sum_j penm_j *
// ((xn[id_j] - s_j) * invm_j)^2 against the row's slack targets s = u[n_u..].
// Penalty: track plus, segment by segment (p, v, q, omega), the sum of
// pen13'_i * (over_i^2 + under_i^2), over/under the scaled one-sided
// violations of [lo13, hi13] (pen13' holds constr_pen).
template <int SC, bool REG>
__device__ __forceinline__ float constr_cost(const ApgArgs& a, const float* c,
                                             const float* xn, const float* u,
                                             float track) {
  if constexpr (SC == CONSTR_PROX) {
    float acc = 0.f;
    for (int j = 0; j < a.m; ++j) {
      const int id = (int)c[a.o_sid + j];
      const float d = ((REG ? pick13(xn, id) : xn[id]) - u[a.n_u + j]) * c[a.o_invm + j];
      acc += c[a.o_penm + j] * d * d;
    }
    track = track + acc;
  } else if constexpr (SC == CONSTR_PENALTY) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {            // segments [0,3) [3,6) [6,10) [10,13)
      const int i0 = g < 3 ? 3 * g : 10, i1 = g < 2 ? 3 * g + 3 : (g == 2 ? 10 : 13);
      float acc = 0.f;
#pragma unroll
      for (int i = i0; i < i1; ++i) {
        const float inv = c[a.o_inv13 + i];
        const float ov = fmaxf(xn[i] - c[a.o_hi13 + i], 0.f) * inv;
        const float un = fmaxf(c[a.o_lo13 + i] - xn[i], 0.f) * inv;
        acc += c[a.o_pen13 + i] * (ov * ov + un * un);
      }
      track = track + acc;
    }
  }
  return track;
}

// Reverse of constr_cost, seeded with cT: adds the terms' cotangent to the
// post-step state's ct (13) and, in the proximal form, writes the slack
// columns' gradient into cu[n_u + j] (the coupling's -d/ds).
template <int SC, bool REG>
__device__ __forceinline__ void constr_bwd(const ApgArgs& a, const float* c,
                                           const float* x1, const float* u, float cT,
                                           float* ct, float* cu) {
  if constexpr (SC == CONSTR_PROX) {
    for (int j = 0; j < a.m; ++j) {
      const int id = (int)c[a.o_sid + j];
      const float inv = c[a.o_invm + j];
      const float dsl = (x1[id] - u[a.n_u + j]) * inv;
      const float gx = cT * 2.f * c[a.o_penm + j] * inv * dsl;
      if constexpr (REG) {
#pragma unroll
        for (int i = 0; i < 13; ++i)
          if (i == id) ct[i] += gx;
      } else {
        ct[id] += gx;
      }
      cu[a.n_u + j] = -gx;
    }
  } else if constexpr (SC == CONSTR_PENALTY) {
    for (int i = 0; i < 13; ++i) {
      const float inv = c[a.o_inv13 + i];
      const float ov = fmaxf(x1[i] - c[a.o_hi13 + i], 0.f) * inv;
      const float un = fmaxf(c[a.o_lo13 + i] - x1[i], 0.f) * inv;
      ct[i] += cT * 2.f * c[a.o_pen13 + i] * inv * (ov - un);
    }
  }
}

// One Euler(-Maruyama) step plus stage cost of one row (the row half of
// bodies.py::make_step): state xr (13), trunk output h (12), controls ur,
// the row's draws zr (PART: v1 += sqrt(dt)*sigma[0:3]*z[3:6],
// om1 += sqrt(dt)*sigma[3:6]*z[10:13] after the drift, in the order of
// bodies.py:160-162); writes the new state to o (13; may alias xr) and
// returns the tracking cost (with the state-constraint terms, constr_cost)
// in track and the sigma penalty in res2. REG (the P=1 forms): xr, h and o
// are register arrays, so no index into them depends on runtime data, the
// wrench mix_eff @ ur comes precomputed in wr (4), and the sigma penalty is
// the caller's (sigma_res2; res2 is left as it is).
template <bool PART, int SC, bool REG = false>
__device__ __forceinline__ void em_step(const ApgArgs& a, const float* c, const float* xr,
                                        const float* h, const float* ur, const float* zr,
                                        int t, float* o, float& track_out, float& res2_out,
                                        const float* wr = nullptr) {
  const float* scal = c + a.o_scal;
  const float* in = c + a.o_inertia;
  const float* ws = c + a.o_wstate;
  const float* r = c + a.o_xref + (t + 1) * 13;
  const float dt = c[a.o_ts + t];
  const float mass = scal[SC_MASS], ds = scal[SC_DIFF];
  float p[3], v[3], q[4], om[3];
  for (int i = 0; i < 3; ++i) { p[i] = xr[i]; v[i] = xr[3 + i]; om[i] = xr[10 + i]; }
  for (int i = 0; i < 4; ++i) q[i] = xr[6 + i];

  float res2 = 0.f, sg6[6];
  if constexpr (!REG) {
    for (int i = 0; i < 6; ++i) {
      const float sg = softplus(h[6 + i]) * ds;
      res2 += sg * sg;
      sg6[i] = sg;
    }
  }
  float w[4];
  if constexpr (REG) {
    for (int m = 0; m < 4; ++m) w[m] = wr[m];
  } else {
    wrench4(a, c + a.o_mix, ur, w);
  }
  const float fb[3] = {h[0], h[1], h[2] - w[0]};
  float rot[3];
  qrot(q[0], q + 1, fb, rot);
  // REG: products with the reciprocals of mass, inertia and |q1| (one
  // division each, off the chain; within an ulp of the quotients)
  const float im = REG ? 1.f / mass : 0.f;
  const float acc[3] = {REG ? rot[0] * im : rot[0] / mass, REG ? rot[1] * im : rot[1] / mass,
                        kG + (REG ? rot[2] * im : rot[2] / mass)};
  float Iom[3], cr[3], dom[3], dq[4];
  for (int i = 0; i < 3; ++i) Iom[i] = in[i] * om[i];
  cross3(om, Iom, cr);
  for (int i = 0; i < 3; ++i) {
    const float num = w[1 + i] + h[3 + i] - cr[i];
    dom[i] = REG ? num * (1.f / in[i]) : num / in[i];
  }
  qdot(q, om, dq);

  float p1[3], v1[3], q1[4], om1[3];
  for (int i = 0; i < 3; ++i) {
    p1[i] = p[i] + dt * v[i];
    v1[i] = v[i] + dt * acc[i];
    om1[i] = om[i] + dt * dom[i];
  }
  if constexpr (PART) {
    const float sd = sqrtf(dt);
    for (int i = 0; i < 3; ++i) {
      v1[i] = v1[i] + sd * sg6[i] * zr[3 + i];
      om1[i] = om1[i] + sd * sg6[3 + i] * zr[10 + i];
    }
  }
  float nq = 0.f;
  for (int i = 0; i < 4; ++i) { q1[i] = q[i] + dt * dq[i]; nq += q1[i] * q1[i]; }
  nq = sqrtf(nq + 1e-12f);
  const float inq = REG ? 1.f / nq : 0.f;
  for (int i = 0; i < 4; ++i) q1[i] = REG ? q1[i] * inq : q1[i] / nq;

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
  float track = tp + tv + tq + tw;

  for (int i = 0; i < 3; ++i) { o[i] = p1[i]; o[3 + i] = v1[i]; o[10 + i] = om1[i]; }
  for (int i = 0; i < 4; ++i) o[6 + i] = q1[i];
  if constexpr (SC != CONSTR_NONE) track = constr_cost<SC, REG>(a, c, o, ur, track);
  track_out = track;
  if constexpr (!REG) res2_out = res2;
}

// One Euler(-Maruyama) step plus stage cost for R rows (bodies.py::
// make_step). Rows and controls as in trunk; the state is read from
// x[r*13..] and the new state written to xn[r*13..] (x and xn may alias).
// PART adds the Brownian term (em_step): row r's draws are z[(r / K)*13 ..]
// (its particle; rows are particle-major). SC adds the state-constraint
// terms (constr_cost). Accumulates jt[r] += d_t * track, jr[r] += d_t * res2.
// TILED: the trunk's register-tiled products (the candidate rows of
// cand_part). BF: the bf16 trunk (trunk). st_h0p, st_h1p: the rows'
// pre-activations stashed there (trunk). GW, wb:
// the weights in device memory (trunk). DOT2: the trunk's compensated sums.
template <bool PART, int SC, bool TILED = false, bool BF = false, bool GW = false,
          bool DOT2 = false>
__device__ void fwd_step(const ApgArgs& a, const Smem& s, int R, const float* U,
                         int ustride, int K, const float* z, const float* x,
                         float* xn, int t, float* st_h0p = nullptr, float* st_h1p = nullptr,
                         const float* wb = nullptr) {
  trunk<PART, TILED, BF, GW, DOT2>(a, s, R, U, ustride, K, x, st_h0p, st_h1p, wb);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* c = s.c;
  const int OUT = a.OUT;

  auto step = [&](int row) {
    const float d_t = c[a.o_disc + t];
    float track, res2;
    em_step<PART, SC>(a, c, x + row * 13, s.a2 + row * OUT,
                      PART ? U + (row % K) * ustride : U + row * ustride,
                      PART ? z + (row / K) * 13 : nullptr, t, xn + row * 13, track, res2);
    s.jt[row] += d_t * track;
    s.jr[row] += d_t * res2;
  };
  if constexpr (PART) {
    for (int row = tid; row < R; row += nt) step(row);
  } else if (tid < R) {
    step(tid);
  }
  __syncthreads();
}

// Reverse of one row's stage cost, sigma penalty, renormalisation, EM
// update and drift at horizon index t: the scalar half of
// bodies.py::manual_bwd_step. st / x1 are the row's states at t and t+1,
// h2 its output pre-activations, u its controls; cT and cR seed the
// tracking and the sigma cost. ct holds the cotangent of x1 on entry and
// that of st (before the feature terms) on exit; c_h2 receives the trunk
// output cotangent and cu the wrench part of the control cotangent. PART
// adds the Brownian term's sigma cotangent sqrt(dt)*z*c_{v1,om1} (zr: the
// row's draws). SC adds the state-constraint cotangents to ct first
// (constr_bwd; the proximal form's slack gradient lands in cu[n_u..]). REG
// (the P=1 forms): ct and c_h2 are register arrays, wr (4) the stashed
// wrench, and c_h2[6..12) the caller's (sigma_bwd); its control cotangent
// covers the first P1_FMAX - 9 controls, or with ALLU (the wide step's
// forms past P1_FMAX inputs) all n_u.
template <bool PART, int SC, bool REG = false, bool ALLU = false>
__device__ __forceinline__ void bwd_dyn(const ApgArgs& a, const float* c,
                                        const float* st, const float* x1,
                                        const float* h2, const float* u,
                                        const float* zr, int t, float cT, float cR,
                                        float* ct, float* c_h2, float* cu,
                                        const float* wr = nullptr) {
  const float* scal = c + a.o_scal;
  const float* in = c + a.o_inertia;
  const float* mix = c + a.o_mix;
  const float dt = c[a.o_ts + t];
  if constexpr (SC != CONSTR_NONE) constr_bwd<SC, REG>(a, c, x1, u, cT, ct, cu);
  {
    const float* ws = c + a.o_wstate;
    const float* r = c + a.o_xref + (t + 1) * 13;
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

    // sigma / res2 (and the Brownian term v1 += sd*sig6[0:3]*z[3:6],
    // om1 += sd*sig6[3:6]*z[10:13]); REG: the caller's (sigma_bwd)
    const float dsc = scal[SC_DIFF];
    for (int i = 0; i < 6 && !REG; ++i) {
      const float hs = h2[6 + i];
      const float sig6 = softplus(hs) * dsc;
      float c_sig6 = cR * 2.f * sig6;
      if constexpr (PART)
        c_sig6 = c_sig6 + sqrtf(dt) * (i < 3 ? zr[3 + i] * cv1[i] : zr[7 + i] * com1[i - 3]);
      c_h2[6 + i] = c_sig6 * sigm(hs) * dsc;
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
    const float inrm = REG ? 1.f / nrm : 0.f;     // REG: reciprocals, as em_step
    float c_q1r[4];
    for (int i = 0; i < 4; ++i) c_q1r[i] = (REG ? cq1[i] * inrm : cq1[i] / nrm) - q1r[i] * coef;

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
      if constexpr (REG) {
        const float cd = c_dom[i] * (1.f / in[i]);
        c_tau[i] = cd;
        c_h2[3 + i] = cd;
        c_crs[i] = -cd;
      } else {
        c_tau[i] = c_dom[i] / in[i];
        c_h2[3 + i] = c_dom[i] / in[i];
        c_crs[i] = -c_dom[i] / in[i];
      }
      Iom[i] = in[i] * om[i];
    }
    cross3(Iom, c_crs, t1);
    cross3(c_crs, om, t2);
    for (int i = 0; i < 3; ++i) com[i] = (com[i] + t1[i]) + in[i] * t2[i];

    // acc = G e_z + qrotate(q, f_body) / mass
    float w[4];
    if constexpr (REG) {
      for (int m = 0; m < 4; ++m) w[m] = wr[m];
    } else {
      wrench4(a, mix, u, w);
    }
    const float fb[3] = {h2[0], h2[1], h2[2] - w[0]};
    float c_rot[3], c_wq, c_uq[3], c_fb[3];
    const float im = REG ? 1.f / scal[SC_MASS] : 0.f;
    for (int i = 0; i < 3; ++i) c_rot[i] = REG ? c_acc[i] * im : c_acc[i] / scal[SC_MASS];
    qrot_bwd(qw, q + 1, fb, c_rot, &c_wq, c_uq, c_fb);
    cq[0] += c_wq;
    for (int i = 0; i < 3; ++i) cq[1 + i] += c_uq[i];
    for (int i = 0; i < 3; ++i) c_h2[i] = c_fb[i];
    const float c_wr[4] = {-c_fb[2], c_tau[0], c_tau[1], c_tau[2]};
    auto mix_t = [&](int i) {
      float acc = 0.f;
      for (int m = 0; m < 4; ++m) acc += c_wr[m] * mix[m * a.n_u + i];
      cu[i] = acc;
    };
    if constexpr (REG && !ALLU) {
#pragma unroll
      for (int i = 0; i < P1_FMAX - 9; ++i) {
        const int ic = min(i, a.n_u - 1);
        float acc = 0.f;
        for (int m = 0; m < 4; ++m) acc += c_wr[m] * mix[m * a.n_u + ic];
        if (i < a.n_u) cu[i] = acc;
      }
    } else {
      for (int i = 0; i < a.n_u; ++i) mix_t(i);
    }
    for (int i = 0; i < 3; ++i) { ct[i] = cp[i]; ct[3 + i] = cv[i]; ct[10 + i] = com[i]; }
    for (int i = 0; i < 4; ++i) ct[6 + i] = cq[i];
  }
}

// Features back to the state and the controls for one row (the feature
// half of manual_bwd_step): ct += the cotangent of the state through the
// features cf, and g[i] = cu[i] + cf[9+i] (g may alias cu). REG (the P=1
// forms): ct and cf are register arrays and the control gradient is the
// caller's (cu and g unused).
template <bool REG = false>
__device__ __forceinline__ void bwd_feat(const ApgArgs& a, const float* st,
                                         const float* cf, const float* cu,
                                         float* ct, float* g) {
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
  if constexpr (!REG)
    for (int i = 0; i < a.n_u; ++i) g[i] = cu[i] + cf[9 + i];
}

// Transposed copies of the trunk weights for bwd_rows, whose transposed
// matvecs then read consecutive addresses across a warp (the weights as
// stored would put a warp's 32 reads in one shared-memory bank). Reads the
// consts copy s.c; ends with a barrier.
__device__ void transpose_weights(const ApgArgs& a, const Smem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int F = a.F, HID = a.HID, OUT = a.OUT;
  const float* c = s.c;
  for (int e = tid; e < F * HID; e += nt) {       // w0 (F, HID)
    const int i = e / HID, j = e - i * HID;
    s.w0t[j * F + i] = c[a.o_w0 + e];
  }
  for (int e = tid; e < HID * HID; e += nt) {     // w1 (HID, HID)
    const int i = e / HID, j = e - i * HID;
    s.w1t[j * HID + i] = c[a.o_w1 + e];
  }
  for (int e = tid; e < HID * OUT; e += nt) {     // w2 (HID, OUT)
    const int j = e / OUT, o = e - j * OUT;
    s.w2t[o * HID + j] = c[a.o_w2 + e];
  }
  __syncthreads();
}

// One reverse step of a chunk of R = a.Pc particle rows at horizon index t:
// the noise branch, which the TPU kernel differentiates by tracing jax.vjp
// of the step (bodies.py:587-596). Like the traced VJP, it re-runs the
// trunk forward, from the stashed states xs[t], into s.p0 / s.p1 / s.a2.
// Each row is seeded with d_t/Pc (the chunk's cost is the mean over its
// rows; z: the chunk's draws at step t); with OPT and a.risk each row's
// control cotangent enters the chunk's sum times its risk weight, which
// vg_part leaves in s.jt[r] (the forward's running costs are spent by
// then). Updates the row cotangents s.ct
// (R, 13) and writes the chunk's control gradient, summed over its rows and
// divided by n_chunks, to gout[t*nZ ..] (its partial; the slack columns'
// gradient rides in s.cu[r*nZ + n_u ..] in the proximal form). Needs
// transpose_weights first. BF (the bf16 trunk): the trunk forward rounds as
// the forward sweep did, and the cotangents entering the transposed
// products (s.c_h2, s.c_h1p, s.c_h0p) are stored rounded. GW (the global-
// weight forms): no transposes; the weights are read in place in device
// memory (s.wg, wt), and a warp's threads take the rows of one unit (idx =
// unit * R + r), so each weight read is one address for the warp (a
// broadcast) and the cotangents s.c_h1p, s.c_h0p sit at row stride
// tiled_ld (rows a warp reads together fall in different banks). Each
// output is still one thread's sum over the same products in the same
// order, so both forms give the same bits.
template <int SC, bool OPT = false, bool BF = false, bool GW = false>
__device__ void bwd_rows(const ApgArgs& a, const Smem& s, const float* U,
                         const float* __restrict__ z, int t, float* gout) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* c = s.c;
  const int R = a.Pc, F = a.F, HID = a.HID, OUT = a.OUT, nZ = a.nZ;
  const float* xt = s.xs + t * R * 13;
  const float* x1 = s.xs + (t + 1) * R * 13;
  const float* u = U + t * nZ;
  trunk<true, false, BF, GW>(a, s, R, u, 0, 1, xt, s.p0, s.p1, GW ? s.wg : nullptr);
  const float d_t = c[a.o_disc + t];
  const float cT = d_t / (float)R, cR = d_t * c[a.o_scal + SC_RESM] / (float)R;
  for (int r = tid; r < R; r += nt) {
    bwd_dyn<true, SC>(a, c, xt + r * 13, x1 + r * 13, s.a2 + r * OUT, u, z + r * 13, t,
                      cT, cR, s.ct + r * 13, s.c_h2 + r * OUT, s.cu + r * nZ);
    if constexpr (BF)
      for (int o = 0; o < OUT; ++o) s.c_h2[r * OUT + o] = bf16_rn(s.c_h2[r * OUT + o]);
  }
  __syncthreads();

  if constexpr (GW) {
    // trunk backward, one output per thread and row, on the weights in
    // device memory: w2t[o][j] = w2[j][o], w1t[j][i] = w1[i][j], w0t[j][i] =
    // w0[i][j]
    const int ld = tiled_ld(a);
    const float* w0 = s.wg + a.o_w0;
    const float* w1 = s.wg + a.o_w1;
    const float* w2 = s.wg + a.o_w2;
    for (int idx = tid; idx < R * HID; idx += nt) {
      const int j = idx / R, r = idx - j * R;
      const float* ch = s.c_h2 + r * OUT;
      float acc = 0.f;
      for (int o = 0; o < OUT; ++o) acc += ch[o] * wt<GW, BF>(w2 + j * OUT + o);
      const float h = s.p1[r * HID + j], s1 = sigm(h);
      s.c_h1p[r * ld + j] = mm_in<BF>(acc * (s1 + h * s1 * (1.f - s1)));
    }
    __syncthreads();
    for (int idx = tid; idx < R * HID; idx += nt) {
      const int i = idx / R, r = idx - i * R;
      const float* ch = s.c_h1p + r * ld;
      float acc = 0.f;
      for (int j = 0; j < HID; ++j) acc += wt<GW, BF>(w1 + i * HID + j) * ch[j];
      const float h = s.p0[r * HID + i], s0 = sigm(h);
      s.c_h0p[r * ld + i] = mm_in<BF>(acc * (s0 + h * s0 * (1.f - s0)));
    }
    __syncthreads();
    for (int idx = tid; idx < R * F; idx += nt) {
      const int i = idx / R, r = idx - i * R;
      const float* ch = s.c_h0p + r * ld;
      float acc = 0.f;
      for (int j = 0; j < HID; ++j) acc += wt<GW, BF>(w0 + i * HID + j) * ch[j];
      s.c_feat[r * F + i] = acc;
    }
    __syncthreads();
  } else {
    // trunk backward, one output per thread and row, on the transposed
    // weights (transpose_weights)
    for (int idx = tid; idx < R * HID; idx += nt) {
      const int r = idx / HID, j = idx - r * HID;
      const float* ch = s.c_h2 + r * OUT;
      float acc = 0.f;
      for (int o = 0; o < OUT; ++o) acc += ch[o] * s.w2t[o * HID + j];
      const float h = s.p1[idx], s1 = sigm(h);
      s.c_h1p[idx] = mm_in<BF>(acc * (s1 + h * s1 * (1.f - s1)));
    }
    __syncthreads();
    for (int idx = tid; idx < R * HID; idx += nt) {
      const int r = idx / HID, i = idx - r * HID;
      const float* ch = s.c_h1p + r * HID;
      float acc = 0.f;
      for (int j = 0; j < HID; ++j) acc += s.w1t[j * HID + i] * ch[j];
      const float h = s.p0[idx], s0 = sigm(h);
      s.c_h0p[idx] = mm_in<BF>(acc * (s0 + h * s0 * (1.f - s0)));
    }
    __syncthreads();
    for (int idx = tid; idx < R * F; idx += nt) {
      const int r = idx / F, i = idx - r * F;
      const float* ch = s.c_h0p + r * HID;
      float acc = 0.f;
      for (int j = 0; j < HID; ++j) acc += s.w0t[j * F + i] * ch[j];
      s.c_feat[idx] = acc;
    }
    __syncthreads();
  }
  for (int r = tid; r < R; r += nt)
    bwd_feat(a, xt + r * 13, s.c_feat + r * F, s.cu + r * nZ, s.ct + r * 13, s.cu + r * nZ);
  __syncthreads();
  if (tid < nZ) {
    float acc = 0.f;
    if (OPT && a.risk)
      for (int r = 0; r < R; ++r) acc += s.jt[r] * s.cu[r * nZ + tid];
    else
      for (int r = 0; r < R; ++r) acc += s.cu[r * nZ + tid];
    gout[t * nZ + tid] = acc / (float)a.n_chunks;
  }
  __syncthreads();
}

// Closed-form gradient of the control-only cost terms at (t, i)
// (bodies.py::vg_sweep, :598-628); 0 on the proximal form's slack columns
// (bodies.py::_prox_pad).
template <int SC>
__device__ float ctrl_grad(const ApgArgs& a, const float* c, const float* U, int t, int i) {
  if constexpr (SC == CONSTR_PROX)
    if (i >= a.n_u) return 0.f;
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
// uerr part, slew part and slew-rate violation (bodies.py::control_cost);
// none on the proximal form's slack columns.
struct CtrlTerms { float u, sl, viol; };
template <int SC>
__device__ __forceinline__ CtrlTerms ctrl_terms(const ApgArgs& a, const float* c,
                                                const float* U, int e) {
  const int t = e / a.nZ, i = e - t * a.nZ;
  CtrlTerms r;
  if constexpr (SC == CONSTR_PROX)
    if (i >= a.n_u) return CtrlTerms{0.f, 0.f, 0.f};
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

// ---- The P=1 forms: apg_solve_kernel<false, SC>, value_and_grad_kernel<
// false, SC>, and on the trunks of their layout value_batch_kernel<false,
// SC, true> and trajectory_kernel<true>. Latency first, blocks of 256
// threads (4 per hidden unit):
// a forward step of R <= 8 rows has two block barriers,
//   warp r (row r):  features, layer 0           -> s.a0   | barrier
//   all threads:     layer 1, split-K            -> s.a1   | barrier
//   warp r:          layer 2, the EM step and stage cost, computed alike in
//                    all 32 lanes, so the new state stays in registers;
// and a reverse step of the vg row two more,
//   warp 0:          bwd_dyn, layer 2 backward   -> s.c_h1p | barrier
//   all threads:     layer 1 backward, split-K   -> s.c_h0p | barrier
//   warp 0:          layer 0 backward, bwd_feat (state cotangent in
//                    registers, control gradient into s.g[t]).
// The trunk weights sit in registers for the whole solve (P1W). Warp-local
// sums over the 32 lanes are reduce-scatters (warp_sum16_scatter), read back
// by shuffles where every lane needs them, so all lanes hold the same
// values; per-solve constants are read from the consts copy in shared
// memory, off the chain.
// Widths are fixed: HID = P1_HID, F <= P1_FMAX, OUT = 12 (other trunks run
// the wide step below, vg_wide).

// Clock-stamped phases (apg_solve_prof_launch): thread 0 adds the SM cycles
// since the previous stamp to s.prof[ph]; s.prof[PH_N] holds the last stamp.
enum { PH_FWD_TRUNK = 0, PH_FWD_SCALAR, PH_BWD_SCALAR, PH_BWD_TRUNK, PH_CAND, PH_LOOP,
       PH_N };
// ... and of the particle form (every block stamps; ranks 0 and cluster-1
// write theirs): the vg chunks' forward and reverse sweeps, the candidate
// chunks' rollouts, the cluster reductions with the wait at their barriers,
// the rest of the loop.
enum { PP_VG_FWD = 0, PP_VG_BWD, PP_CAND, PP_RED, PP_LOOP, PP_N };
static_assert((int)PP_N <= (int)PH_N, "the particle phases share the stamp buffer");
template <bool PROF>
__device__ __forceinline__ void prof_stamp(const Smem& s, int ph) {
  if constexpr (PROF) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      s.prof[ph] += now - s.prof[PH_N];
      s.prof[PH_N] = now;
    }
  }
}

// The trunk in registers. Lane l of every warp holds the w0 and w2 rows of
// hidden units l and l+32 (layers 0 and 2 and their reverse are
// warp-local); thread 4j+k holds the 16 inputs i = 16m+4k+q (m, q < 4) of
// hidden unit j of layer 1, forward (w1[i][j]) and reverse (w1[j][i]).
struct P1W {
  float w0[2][P1_FMAX];   // w0[f][l + 32h], zero past F
  float w2[2][P1_OUT];    // w2[l + 32h][o]
  float w1f[16], w1b[16]; // [4m + q]
  float b0[2], b1;        // b0[l + 32h], b1[j]
};

__device__ __forceinline__ P1W load_p1_weights(const ApgArgs& a, const float* c) {
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 2, k = threadIdx.x & 3;
  P1W W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = lane + 32 * h;
#pragma unroll
    for (int f = 0; f < P1_FMAX; ++f) W.w0[h][f] = f < a.F ? c[a.o_w0 + f * P1_HID + u] : 0.f;
#pragma unroll
    for (int o = 0; o < P1_OUT; ++o) W.w2[h][o] = c[a.o_w2 + u * P1_OUT + o];
    W.b0[h] = c[a.o_b0 + u];
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 16 * m + 4 * k + q;
      W.w1f[4 * m + q] = c[a.o_w1 + i * P1_HID + j];
      W.w1b[4 * m + q] = c[a.o_w1 + j * P1_HID + i];
    }
  W.b1 = c[a.o_b1 + j];
  return W;
}

static_assert(P1_FMAX == 16 && P1_OUT <= 16, "warp_sum16_scatter: 16 sums per warp");

// Sum 16 values v[o] over the warp, scattered: halving exchanges (8, 4, 2,
// 1 shuffles) then a last xor, 16 shuffles for 16 sums. Lanes 2o and 2o+1
// return the sum of v[o] (o = lane/2), bit-identical in both.
__device__ __forceinline__ float warp_sum16_scatter(const float* v) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float a[8], b[4], c[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (b4 ? v[8 + i] : v[i]) + __shfl_xor_sync(full, b4 ? v[i] : v[8 + i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (b3 ? a[4 + i] : a[i]) + __shfl_xor_sync(full, b3 ? a[i] : a[4 + i], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (b2 ? b[2 + i] : b[i]) + __shfl_xor_sync(full, b2 ? b[i] : b[2 + i], 4);
  const float d = (b1 ? c[1] : c[0]) + __shfl_xor_sync(full, b1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(full, d, 1);
}

// The 16 inputs of this thread's hidden unit j from a 64-float vector in
// shared memory (16-byte aligned): four float4 reads, conflict-free.
__device__ __forceinline__ float dot16(const float* v, const float* w) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int k = threadIdx.x & 3;
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 x = v4[4 * m + k];
    acc += x.x * w[4 * m];
    acc += x.y * w[4 * m + 1];
    acc += x.z * w[4 * m + 2];
    acc += x.w * w[4 * m + 3];
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

// Features of a row in registers (as trunk's) from load_controls' uu, zero
// past F.
__device__ __forceinline__ void features_reg(const ApgArgs& a, const float* x,
                                             const float* uu, float* f) {
  const float qcu[3] = {-x[7], -x[8], -x[9]};
  const float ez[3] = {0.f, 0.f, 1.f};
  qrot(x[6], qcu, x + 3, f);
  f[3] = x[10]; f[4] = x[11]; f[5] = x[12];
  qrot(x[6], qcu, ez, f + 6);
#pragma unroll
  for (int i = 0; i < P1_FMAX - 9; ++i) f[9 + i] = i < a.n_u ? uu[i] : 0.f;
}

// The sigma penalty of a row, its 6 softplus terms one per lane: lane 2o
// holds the trunk output o in `mine` (warp_sum16_scatter); every lane gets
// sum_i (softplus(h[6+i]) * ds)^2 in em_step's order.
__device__ __forceinline__ float sigma_res2(float mine, float ds) {
  const float sg = softplus(mine) * ds;
  float res2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float v = __shfl_sync(0xffffffffu, sg, 2 * (6 + i));
    res2 += v * v;
  }
  return res2;
}

// The sigma part of a row's output cotangent, one term per lane as
// bwd_dyn's loop computes it (h2: the row's 12 stashed outputs, cR the
// sigma cost's seed): c_h2[6 + i] in every lane.
__device__ __forceinline__ void sigma_bwd(const float* h2, float cR, float dsc, float* c_h2) {
  const int i = (threadIdx.x & 31) % 6;
  const float hs = h2[6 + i];
  const float sig6 = softplus(hs) * dsc;
  const float v = cR * 2.f * sig6 * sigm(hs) * dsc;
#pragma unroll
  for (int k = 0; k < 6; ++k) c_h2[6 + k] = __shfl_sync(0xffffffffu, v, k);
}

// R rows through the horizon from x0, warp r < R owning row r, whose
// controls at step t are U[r*ustride + t*nZ ..]; row r's costs land in
// s.jt[r], s.jr[r]. STASH (the vg row and the trajectory, R = 1): the
// states into s.xs[1..H], the pre-activations into s.h0p, s.h1p, s.h2 and
// the wrench into s.wr for the reverse sweep. Ends without a barrier (warp r
// wrote row r's costs, warp 0 the stash). BF (the P=1 value_batch's bf16
// instantiations): the features and the swish outputs rounded to bf16 before
// the products read them (W from a rounded consts copy; header).
template <int SC, bool STASH, bool PROF, bool BF = false>
__device__ __forceinline__ void p1_rollout(const ApgArgs& a, const Smem& s, const P1W& W,
                                           int R, const float* U, int ustride) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid >> 2, k = tid & 3;
  const float* c = s.c;
  const bool own = warp < R;
  const float* Ur = U + warp * ustride;
  float x[13], jt = 0.f, jr = 0.f;
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = c[a.o_x0 + i];
  for (int t = 0; t < a.H; ++t) {
    const float* ut = Ur + t * a.nZ;
    float w[4];                                  // the wrench of u_t
    if (own) {
      float uu[P1_FMAX - 9], f[P1_FMAX];
      load_controls(a, ut, uu);
      features_reg(a, x, uu, f);
      if constexpr (BF) {
#pragma unroll
        for (int i = 0; i < P1_FMAX; ++i) f[i] = bf16_rn(f[i]);
      }
      wrench4_reg(a, c + a.o_mix, uu, w);
      if (STASH) prof_stamp<PROF>(s, PH_FWD_SCALAR);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < P1_FMAX; ++i) acc += f[i] * W.w0[h][i];
        const float pre = acc + W.b0[h];
        s.a0[warp * P1_HID + lane + 32 * h] = mm_in<BF>(pre * sigm(pre));
        if (STASH) s.h0p[t * P1_HID + lane + 32 * h] = pre;
      }
      if (STASH && lane < 4)
        s.wr[t * 4 + lane] = lane == 0 ? w[0] : lane == 1 ? w[1] : lane == 2 ? w[2] : w[3];
    }
    __syncthreads();
    {
      // every thread of hidden unit j holds each row's sum; thread k takes
      // the swish of rows k and k + 4
      float pre[APG_MAXK];
#pragma unroll
      for (int r = 0; r < APG_MAXK; ++r)
        pre[r] = r < R ? dot16(s.a0 + r * P1_HID, W.w1f) + W.b1 : 0.f;
#pragma unroll
      for (int q = 0; q < APG_MAXK / 4; ++q) {
        const int r = k + 4 * q;
        float v = pre[0];
#pragma unroll
        for (int i = 1; i < APG_MAXK; ++i) v = r == i ? pre[i] : v;
        if (r < R) {
          s.a1[r * P1_HID + j] = mm_in<BF>(v * sigm(v));
          if (STASH) s.h1p[t * P1_HID + j] = v;
        }
      }
    }
    __syncthreads();
    if (own) {
      const float* a1 = s.a1 + warp * P1_HID;
      const float v0 = a1[lane], v1 = a1[lane + 32];
      float p[16];
#pragma unroll
      for (int o = 0; o < 16; ++o) p[o] = o < P1_OUT ? v1 * W.w2[1][o] + v0 * W.w2[0][o] : 0.f;
      const int o = lane >> 1;                   // this lane's output unit
      const float mine = warp_sum16_scatter(p) + (o < P1_OUT ? c[a.o_b2 + o] : 0.f);
      float h2[P1_OUT];
#pragma unroll
      for (int i = 0; i < P1_OUT; ++i) h2[i] = __shfl_sync(0xffffffffu, mine, 2 * i);
      const float res2 = sigma_res2(mine, c[a.o_scal + SC_DIFF]);
      if (STASH) prof_stamp<PROF>(s, PH_FWD_TRUNK);
      float track, unused;
      em_step<false, SC, true>(a, c, x, h2, ut, nullptr, t, x, track, unused, w);
      const float d_t = c[a.o_disc + t];
      jt += d_t * track;
      jr += d_t * res2;
      if (STASH) {
        if (!(lane & 1) && o < P1_OUT) s.h2[t * P1_OUT + o] = mine;
        if (lane < 13) s.xs[(t + 1) * 13 + lane] = pick13(x, lane);
      }
    }
  }
  if (own && lane == 0) { s.jt[warp] = jt; s.jr[warp] = jr; }
  if (STASH) prof_stamp<PROF>(s, PH_FWD_SCALAR);
}

// The manual reverse sweep of the vg row (bodies.py::manual_bwd_step, B = 1)
// on the stash of p1_rollout<STASH>: the dynamics part of the control
// gradient (with the slack columns' in the proximal form) into s.g. Ends
// with a barrier.
template <int SC, bool PROF>
__device__ __forceinline__ void p1_reverse(const ApgArgs& a, const Smem& s, const P1W& W,
                                           const float* U) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, j = tid >> 2;
  const float* c = s.c;
  const int nZ = a.nZ;
  float ct[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) ct[i] = 0.f;
  __syncwarp();                                  // warp 0's stash writes
  for (int t = a.H - 1; t >= 0; --t) {
    const float* st = s.xs + t * 13;
    if (warp == 0) {
      const float d_t = c[a.o_disc + t];
      const float cR = d_t * c[a.o_scal + SC_RESM];
      float c_h2[P1_OUT];
      sigma_bwd(s.h2 + t * P1_OUT, cR, c[a.o_scal + SC_DIFF], c_h2);
      bwd_dyn<false, SC, true>(a, c, st, st + 13, s.h2 + t * P1_OUT, U + t * nZ, nullptr, t,
                               d_t, cR, ct, c_h2, s.cu, s.wr + t * 4);
      prof_stamp<PROF>(s, PH_BWD_SCALAR);
      const float* h1p = s.h1p + t * P1_HID;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = lane + 32 * h;
        float acc = 0.f;
#pragma unroll
        for (int o = 0; o < P1_OUT; ++o) acc += c_h2[o] * W.w2[h][o];
        const float s1 = sigm(h1p[u]);
        s.c_h1p[u] = acc * (s1 + h1p[u] * s1 * (1.f - s1));
      }
    }
    __syncthreads();
    {
      const float acc = dot16(s.c_h1p, W.w1b);
      if ((tid & 3) == 0) {
        const float h = s.h0p[t * P1_HID + j], s0 = sigm(h);
        s.c_h0p[j] = acc * (s0 + h * s0 * (1.f - s0));
      }
    }
    __syncthreads();
    if (warp == 0) {
      const float g0 = s.c_h0p[lane], g1 = s.c_h0p[lane + 32];
      float cf[P1_FMAX];
#pragma unroll
      for (int f = 0; f < P1_FMAX; ++f) cf[f] = W.w0[1][f] * g1 + W.w0[0][f] * g0;
      const float mine = warp_sum16_scatter(cf);
#pragma unroll
      for (int f = 0; f < P1_FMAX; ++f) cf[f] = __shfl_sync(0xffffffffu, mine, 2 * f);
      prof_stamp<PROF>(s, PH_BWD_TRUNK);
      bwd_feat<true>(a, st, cf, nullptr, ct, nullptr);
      // step t's control gradient: bwd_dyn's cotangent plus the features'
      float* g = s.g + t * nZ;
#pragma unroll
      for (int i = 0; i < P1_FMAX - 9; ++i) {
        const float v = s.cu[min(i, a.n_u - 1)] + cf[9 + i];
        if (i < a.n_u && lane == 0) g[i] = v;
      }
      if constexpr (SC == CONSTR_PROX)
        for (int i = a.n_u + lane; i < nZ; i += 32) g[i] = s.cu[i];
    }
  }
  prof_stamp<PROF>(s, PH_BWD_SCALAR);
  __syncthreads();
}

// Value and gradient of the iterate U (bodies.py::vg_sweep) at P=1:
// checkpointed forward sweep into the stash (s.xs is the mean trajectory,
// x_evol), manual reverse sweep, closed-form control gradients. Gradient
// lands in s.g, the value in *fval (shared memory). U must be visible to
// the block on entry.
template <int SC, bool PROF = false>
__device__ __forceinline__ void vg(const ApgArgs& a, const Smem& s, const P1W& W,
                                   float* fval, const float* U) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* c = s.c;
  const int HZ = a.H * a.nZ;
  if (tid < 13) s.xs[tid] = c[a.o_x0 + tid];
  p1_rollout<SC, true, PROF>(a, s, W, 1, U, 0);
  p1_reverse<SC, PROF>(a, s, W, U);
  for (int e = tid; e < HZ; e += blockDim.x) {
    const int t = e / a.nZ, i = e - t * a.nZ;
    s.g[e] = s.g[e] + ctrl_grad<SC>(a, c, U, t, i);
  }
  if (warp == 0) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).u; }, s.red + 0);
  if (warp == 1) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).sl; }, s.red + 1);
  if (warp == 2) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).viol; }, s.red + 2);
  __syncthreads();
  if (tid == 0) {
    const float* scal = c + a.o_scal;
    float jc = scal[SC_UERR] * s.red[0] + scal[SC_SLEW] * s.red[1];
    if (a.has_slew) jc = jc + scal[SC_SLEWC] * s.red[2];
    *fval = s.jt[0] + scal[SC_RESM] * s.jr[0] + jc;
  }
  __syncthreads();
}

// ---- The P=1 wide step (P1_SMEM / P1_GLOBAL, apg_solve.cuh):
// apg_solve_kernel<false, SC, ..., STEP> and value_and_grad_kernel<false,
// SC, ..., STEP> on trunks of any width (value_batch and trajectory keep
// fwd_step<false> on them). The register chain's structure over a runtime
// HID, on a block of APG_NTHREADS threads (kSlices warps): a forward step of
// R <= APG_MAXK rows has two block barriers,
//   warp r (row r):  features and wrench in registers, layer 0 (lane l the
//                    units l + 32c)                       -> s.a0   | barrier
//   every warp w:    layer 1's partial sums over input slice w of every row
//                    (wide_l1_partials)                   -> s.pp   | barrier
//   warp r:          the slices' sums, swish, layer 2 (a scattered warp sum),
//                    the Euler step and stage cost computed alike in all 32
//                    lanes, so the new state stays in registers;
// and a reverse step of the vg row two more,
//   warp 0:          sigma_bwd, bwd_dyn, layer 2 backward -> s.c_h1p | barrier
//   every warp:      layer 1 backward, 16 hidden units a warp at a time on
//                    the stored layout (wide_l1_back)     -> s.c_h0p | barrier
//   warp 0:          layer 0 backward, bwd_feat (the state cotangent in
//                    registers, the control gradient into s.g[t]).
// What bounds it: with the weights in shared memory, latency, as the chain
// (a step's trunk 3-4x the chain's at 128 units: 4x its layer 1, read from
// shared memory, not registers); with them in device memory, the reads of
// w1 from L2 every step. Layer 1 (HID^2 products, the only part that grows
// with the square of the width) runs over all the block's threads, each
// slice HID / kSlices inputs deep; every other part is one warp's. The
// weights stay where the form keeps them, in the block's consts
// copy (s.c) or in device memory (GW: scenario 0's consts, through wt), and
// are read in the stored layout, each warp load over consecutive addresses
// (w0 and w1 along their rows; w2 from its transposed copy s.w2t, made once
// per block, wide_prep). The stash, the slice sums s.pp and s.w2t lie in
// shared memory, or, where the global-weight form's block would not fit
// 227 KB with them (past ~620 units), in the scenario's region of the
// launch's scratch in device memory (the kernels' layout, `far`), which
// the block barriers order as they order shared memory. Every sum runs in
// an order fixed by HID alone, so
// both forms give the same bits, a row's sums do not depend on the rows
// beside it (a candidate equal to the iterate gets the vg row's costs), and
// a scenario's bits do not depend on the launch's others.
constexpr int kSlices = APG_NTHREADS / 32;   // layer 1's input slices, a warp each

// The wide step's transposed output layer s.w2t (OUT, HID) from the block's
// consts copy or (GW) from wb in device memory. Every thread; ends with a
// barrier.
template <bool GW>
__device__ void wide_prep(const ApgArgs& a, const Smem& s, const float* wb) {
  const float* w2 = (GW ? wb : s.c) + a.o_w2;
  for (int e = threadIdx.x; e < a.HID * a.OUT; e += blockDim.x) {
    const int j = e / a.OUT, o = e - j * a.OUT;
    s.w2t[o * a.HID + j] = wt<GW>(w2 + e);
  }
  __syncthreads();
}

// Layer 1 of the rows r0 .. r0+RM-1 (those below R) over the block: warp w
// sums the inputs i in [w*HID/kSlices, (w+1)*HID/kSlices) in order, lane l
// the units j = l + 32c, s.pp[(w*R + r)*HID + j] = sum_i s.a0[r*HID + i] *
// w1[i*HID + j]. The RM rows' sums sit in registers, so each weight read
// feeds RM products; a partial's products and their order do not depend on
// RM, r0 or R. The input loop is unrolled 8 deep in shared memory and 4 in
// the global-weight form, whose 64-bit addresses took the whole solve past
// 255 registers at 8 (16 was no faster than 8 there; PERF.md §6).
template <int RM, bool GW>
__device__ __forceinline__ void wide_l1_partials(const ApgArgs& a, const Smem& s,
                                                 const float* w1, int R, int r0 = 0) {
  constexpr int UC = 4;                      // units a lane sums at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, HID = a.HID;
  const int lo = warp * HID / kSlices, hi = (warp + 1) * HID / kSlices;
  for (int c0 = 0; c0 < HID; c0 += 32 * UC) {
    int col[UC];
#pragma unroll
    for (int q = 0; q < UC; ++q) col[q] = min(c0 + lane + 32 * q, HID - 1);
    float acc[RM][UC];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < UC; ++q) acc[r][q] = 0.f;
    auto input = [&](int i) {
      float w[UC];
#pragma unroll
      for (int q = 0; q < UC; ++q) w[q] = wt<GW>(w1 + i * HID + col[q]);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float av = s.a0[min(r0 + r, R - 1) * HID + i];
#pragma unroll
        for (int q = 0; q < UC; ++q) acc[r][q] = fmaf(av, w[q], acc[r][q]);
      }
    };
    if constexpr (GW) {
#pragma unroll 4
      for (int i = lo; i < hi; ++i) input(i);
    } else {
#pragma unroll 8
      for (int i = lo; i < hi; ++i) input(i);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < UC; ++q) {
        const int j = c0 + lane + 32 * q;
        if (r0 + r < R && j < HID) s.pp[(warp * R + r0 + r) * HID + j] = acc[r][q];
      }
  }
}

// A lane's hidden units in the wide step's warp-local layers: the units
// l + 32m (unit_at(m)), taken wide_group<GW> at a time (m = m0 .. m0 + WG -
// 1) so that their reads and swishes overlap; a unit past HID reads unit
// HID - 1 (`uc`) and its value goes unused (as a product with 0 in layer 2:
// unconditional reads keep the group's loads in flight together). The
// global-weight form takes 2 (4 took its whole solve past 255 registers);
// the forms over more than P1_FMAX inputs (FX) half as many (at 4 and 2 the
// whole solve's constrained forms took 255 registers and spilled 12-16 B in
// the global-weight form).
template <bool GW, bool FX = false>
constexpr int wide_group = FX ? (GW ? 1 : 2) : (GW ? 2 : 4);
__device__ __forceinline__ int unit_at(int m) { return (threadIdx.x & 31) + 32 * m; }

// R rows through the horizon from x0 on the wide step, warp r < R owning row
// r, whose controls at step t are U[r*ustride + t*nZ ..]; row r's costs land
// in s.jt[r], s.jr[r]. STASH (the vg row, R = 1): the states into
// s.xs[1..H], the pre-activations into s.h0p, s.h1p, the outputs into s.h2
// and the wrench into s.wr for the reverse sweep; PROF then stamps the
// chain's forward phases. wb: where GW reads the trunk. FX (trunks of more
// than P1_FMAX inputs, F = 9 + n_u > 16): the features past the first
// P1_FMAX (controls 7 ..) are read from the row's controls where layer 0
// takes them, in input order after the first P1_FMAX, and the wrench sums
// all n_u controls (wrench4_all); without it the first P1_FMAX inputs are
// all there are. Ends without a barrier (warp r wrote row r's costs, warp 0
// the stash).
template <int SC, bool STASH, bool GW, bool PROF = false, bool FX = false>
__device__ void wide_rollout(const ApgArgs& a, const Smem& s, const float* wb, int R,
                             const float* U, int ustride) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = s.c;
  const float* W = GW ? wb : c;
  const int HID = a.HID, F = a.F, NU = (HID + 31) / 32;
  constexpr int WG = wide_group<GW, FX>;
  const bool own = warp < R;
  const float* Ur = U + (own ? warp : 0) * ustride;
  float x[13], jt = 0.f, jr = 0.f;
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = c[a.o_x0 + i];
  for (int t = 0; t < a.H; ++t) {
    const float* ut = Ur + t * a.nZ;
    float w[4];                                  // the wrench of u_t
    if (own) {
      float uu[P1_FMAX - 9], f[P1_FMAX];
      load_controls(a, ut, uu);
      features_reg(a, x, uu, f);
      if constexpr (FX) wrench4_all(a, c + a.o_mix, ut, w);
      else wrench4_reg(a, c + a.o_mix, uu, w);
      if (STASH) prof_stamp<PROF>(s, PH_FWD_SCALAR);
      for (int m0 = 0; m0 < NU; m0 += WG) {
        float acc[WG];
        int uc[WG];
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          acc[q] = 0.f;
          uc[q] = min(unit_at(m0 + q), HID - 1);
        }
#pragma unroll
        for (int i = 0; i < P1_FMAX; ++i)
          if (i < F) {
#pragma unroll
            for (int q = 0; q < WG; ++q)
              acc[q] = fmaf(f[i], wt<GW>(W + a.o_w0 + i * HID + uc[q]), acc[q]);
          }
        if constexpr (FX) {
          for (int i = P1_FMAX; i < F; ++i) {
            const float fi = ut[i - 9];                // control i - 9
#pragma unroll
            for (int q = 0; q < WG; ++q)
              acc[q] = fmaf(fi, wt<GW>(W + a.o_w0 + i * HID + uc[q]), acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          const int u = unit_at(m0 + q);
          const float pre = acc[q] + wt<GW>(W + a.o_b0 + uc[q]);
          if (u < HID) {
            s.a0[warp * HID + u] = pre * sigm(pre);
            if (STASH) s.h0p[t * HID + u] = pre;
          }
        }
      }
      if (STASH && lane < 4)
        s.wr[t * 4 + lane] = lane == 0 ? w[0] : lane == 1 ? w[1] : lane == 2 ? w[2] : w[3];
    }
    __syncthreads();
    if (STASH || R == 1) {
      wide_l1_partials<1, GW>(a, s, W + a.o_w1, R);
    } else {                                     // four rows a pass
      for (int r0 = 0; r0 < R; r0 += 4) wide_l1_partials<4, GW>(a, s, W + a.o_w1, R, r0);
    }
    __syncthreads();
    if (own) {
      // the slices' sums in slice order plus the bias, the swish, and this
      // lane's share of layer 2 (its units in order)
      float p[16];
#pragma unroll
      for (int o = 0; o < 16; ++o) p[o] = 0.f;
      for (int m0 = 0; m0 < NU; m0 += WG) {
        float pre[WG];
        int uc[WG];
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          uc[q] = min(unit_at(m0 + q), HID - 1);
          pre[q] = s.pp[warp * HID + uc[q]];
        }
#pragma unroll
        for (int k = 1; k < kSlices; ++k)
#pragma unroll
          for (int q = 0; q < WG; ++q) pre[q] += s.pp[(k * R + warp) * HID + uc[q]];
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          const int u = unit_at(m0 + q);
          pre[q] += wt<GW>(W + a.o_b1 + uc[q]);
          if (STASH && u < HID) s.h1p[t * HID + u] = pre[q];
          pre[q] = u < HID ? pre[q] * sigm(pre[q]) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < WG; ++q)
#pragma unroll
          for (int o = 0; o < P1_OUT; ++o) p[o] = fmaf(pre[q], s.w2t[o * HID + uc[q]], p[o]);
      }
      const int o = lane >> 1;                   // this lane's output unit
      const float mine = warp_sum16_scatter(p) +
                         (o < P1_OUT ? wt<GW>(W + a.o_b2 + min(o, P1_OUT - 1)) : 0.f);
      float h2[P1_OUT];
#pragma unroll
      for (int i = 0; i < P1_OUT; ++i) h2[i] = __shfl_sync(0xffffffffu, mine, 2 * i);
      const float res2 = sigma_res2(mine, c[a.o_scal + SC_DIFF]);
      if (STASH) prof_stamp<PROF>(s, PH_FWD_TRUNK);
      float track, unused;
      em_step<false, SC, true>(a, c, x, h2, ut, nullptr, t, x, track, unused, w);
      const float d_t = c[a.o_disc + t];
      jt += d_t * track;
      jr += d_t * res2;
      if (STASH) {
        if (!(lane & 1) && o < P1_OUT) s.h2[t * P1_OUT + o] = mine;
        if (lane < 13) s.xs[(t + 1) * 13 + lane] = pick13(x, lane);
      }
    }
  }
  if (own && lane == 0) { s.jt[warp] = jt; s.jr[warp] = jr; }
  if (STASH) prof_stamp<PROF>(s, PH_FWD_SCALAR);
}

// Layer 1 backward of the vg row at step t over the block: warp w takes the
// hidden units i0 .. i0+15 (i0 = 16w, 16(w + kSlices), ...), lane l their
// products with the cotangents j = l + 32m (m in order) along the rows of
// w1 as stored, and one scattered warp sum per 16 units (warp_sum16_scatter);
// s.c_h0p[i] = that sum times the swish derivative at s.h0p[t*HID + i].
template <bool GW>
__device__ __forceinline__ void wide_l1_back(const ApgArgs& a, const Smem& s,
                                             const float* w1, int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, HID = a.HID;
  const int NU = (HID + 31) / 32;
  for (int i0 = 16 * warp; i0 < HID; i0 += 16 * kSlices) {
    int row[16];                                 // the units' rows, as offsets
#pragma unroll
    for (int o = 0; o < 16; ++o) row[o] = min(i0 + o, HID - 1) * HID;
    float v[16];
#pragma unroll
    for (int o = 0; o < 16; ++o) v[o] = 0.f;
    auto cotangent = [&](int m) {
      const int j = lane + 32 * m, jc = min(j, HID - 1);
      const float cj = j < HID ? s.c_h1p[jc] : 0.f;
#pragma unroll
      for (int o = 0; o < 16; ++o) v[o] = fmaf(wt<GW>(w1 + row[o] + jc), cj, v[o]);
    };
    if constexpr (GW) {                          // registers: as wide_l1_partials
      for (int m = 0; m < NU; ++m) cotangent(m);
    } else {
#pragma unroll 2
      for (int m = 0; m < NU; ++m) cotangent(m);
    }
    const float mine = warp_sum16_scatter(v);
    const int i = i0 + (lane >> 1);
    if (!(lane & 1) && i < HID) {
      const float h = s.h0p[t * HID + i], s0 = sigm(h);
      s.c_h0p[i] = mine * (s0 + h * s0 * (1.f - s0));
    }
  }
}

// The manual reverse sweep of the vg row (bodies.py::manual_bwd_step, B = 1)
// on the stash of wide_rollout<STASH>: the dynamics part of the control
// gradient (with the slack columns' in the proximal form) into s.g; PROF
// stamps the chain's reverse phases. FX (more than P1_FMAX inputs): the
// wrench's cotangent over all n_u controls (bwd_dyn's ALLU), and layer 0's
// transpose past the first P1_FMAX inputs in slices of P1_FMAX, one
// scattered warp sum each, each control's gradient from its input's lanes.
// Ends with a barrier.
template <int SC, bool GW, bool PROF = false, bool FX = false>
__device__ void wide_reverse(const ApgArgs& a, const Smem& s, const float* wb,
                             const float* U) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* c = s.c;
  const float* W = GW ? wb : c;
  const int HID = a.HID, F = a.F, nZ = a.nZ, NU = (HID + 31) / 32;
  constexpr int WG = wide_group<GW, FX>;
  float ct[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) ct[i] = 0.f;
  __syncwarp();                                  // warp 0's stash writes
  for (int t = a.H - 1; t >= 0; --t) {
    const float* st = s.xs + t * 13;
    if (warp == 0) {
      const float d_t = c[a.o_disc + t];
      const float cR = d_t * c[a.o_scal + SC_RESM];
      float c_h2[P1_OUT];
      sigma_bwd(s.h2 + t * P1_OUT, cR, c[a.o_scal + SC_DIFF], c_h2);
      bwd_dyn<false, SC, true, FX>(a, c, st, st + 13, s.h2 + t * P1_OUT, U + t * nZ, nullptr,
                                   t, d_t, cR, ct, c_h2, s.cu, s.wr + t * 4);
      prof_stamp<PROF>(s, PH_BWD_SCALAR);
      const float* h1p = s.h1p + t * HID;
      for (int m0 = 0; m0 < NU; m0 += WG) {
        float acc[WG];
        int uc[WG];
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          acc[q] = 0.f;
          uc[q] = min(unit_at(m0 + q), HID - 1);
        }
#pragma unroll
        for (int o = 0; o < P1_OUT; ++o)
#pragma unroll
          for (int q = 0; q < WG; ++q) acc[q] = fmaf(c_h2[o], s.w2t[o * HID + uc[q]], acc[q]);
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          const float h = h1p[uc[q]], s1 = sigm(h);
          if (unit_at(m0 + q) < HID) s.c_h1p[uc[q]] = acc[q] * (s1 + h * s1 * (1.f - s1));
        }
      }
    }
    __syncthreads();
    wide_l1_back<GW>(a, s, W + a.o_w1, t);
    __syncthreads();
    if (warp == 0) {
      float cf[P1_FMAX];
#pragma unroll
      for (int f = 0; f < P1_FMAX; ++f) cf[f] = 0.f;
#pragma unroll 2
      for (int m = 0; m < NU; ++m) {
        const int j = lane + 32 * m, jc = min(j, HID - 1);
        const float g = j < HID ? s.c_h0p[jc] : 0.f;
#pragma unroll
        for (int f = 0; f < P1_FMAX; ++f)
          if (f < F) cf[f] = fmaf(wt<GW>(W + a.o_w0 + f * HID + jc), g, cf[f]);
      }
      const float mine = warp_sum16_scatter(cf);
#pragma unroll
      for (int f = 0; f < P1_FMAX; ++f) cf[f] = __shfl_sync(0xffffffffu, mine, 2 * f);
      prof_stamp<PROF>(s, PH_BWD_TRUNK);
      bwd_feat<true>(a, st, cf, nullptr, ct, nullptr);
      // step t's control gradient: bwd_dyn's cotangent plus the features'
      float* g = s.g + t * nZ;
#pragma unroll
      for (int i = 0; i < P1_FMAX - 9; ++i) {
        const float v = s.cu[min(i, a.n_u - 1)] + cf[9 + i];
        if (i < a.n_u && lane == 0) g[i] = v;
      }
      if constexpr (FX) {
        // the inputs past the first P1_FMAX, P1_FMAX at a time: input f0 + o
        // in lanes 2o, 2o + 1, its control's gradient as above
        for (int f0 = P1_FMAX; f0 < F; f0 += P1_FMAX) {
#pragma unroll
          for (int f = 0; f < P1_FMAX; ++f) cf[f] = 0.f;
          for (int m = 0; m < NU; ++m) {
            const int j = lane + 32 * m, jc = min(j, HID - 1);
            const float gj = j < HID ? s.c_h0p[jc] : 0.f;
#pragma unroll
            for (int f = 0; f < P1_FMAX; ++f)
              if (f0 + f < F) cf[f] = fmaf(wt<GW>(W + a.o_w0 + (f0 + f) * HID + jc), gj, cf[f]);
          }
          const float v = warp_sum16_scatter(cf);
          const int i = f0 + (lane >> 1) - 9;
          if (!(lane & 1) && i < a.n_u) g[i] = s.cu[i] + v;
        }
      }
      if constexpr (SC == CONSTR_PROX)
        for (int i = a.n_u + lane; i < nZ; i += 32) g[i] = s.cu[i];
    }
  }
  prof_stamp<PROF>(s, PH_BWD_SCALAR);
  __syncthreads();
}

// Value and gradient of the iterate U (bodies.py::vg_sweep) at P=1 on the
// wide step: the forward sweep from x0 into the stash (s.xs is the mean
// trajectory, x_evol), the manual reverse sweep, the closed-form control
// gradients and the control-only terms, as vg ends. The gradient lands in
// s.g, the value in *fval (shared memory). U and s.w2t (wide_prep) must be
// visible to the block on entry. PROF: the chain's clock stamps. FX: more
// than P1_FMAX trunk inputs (wide_rollout).
template <int SC, bool GW, bool PROF = false, bool FX = false>
__device__ void vg_wide(const ApgArgs& a, const Smem& s, const float* wb, float* fval,
                        const float* U) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* c = s.c;
  const int HZ = a.H * a.nZ;
  if (tid < 13) s.xs[tid] = c[a.o_x0 + tid];
  wide_rollout<SC, true, GW, PROF, FX>(a, s, wb, 1, U, 0);
  wide_reverse<SC, GW, PROF, FX>(a, s, wb, U);
  for (int e = tid; e < HZ; e += blockDim.x) {
    const int t = e / a.nZ, i = e - t * a.nZ;
    s.g[e] = s.g[e] + ctrl_grad<SC>(a, c, U, t, i);
  }
  if (warp == 0) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).u; }, s.red + 0);
  if (warp == 1) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).sl; }, s.red + 1);
  if (warp == 2) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).viol; }, s.red + 2);
  __syncthreads();
  if (tid == 0) {
    const float* scal = c + a.o_scal;
    float jc = scal[SC_UERR] * s.red[0] + scal[SC_SLEW] * s.red[1];
    if (a.has_slew) jc = jc + scal[SC_SLEWC] * s.red[2];
    *fval = s.jt[0] + scal[SC_RESM] * s.jr[0] + jc;
  }
  __syncthreads();
}

// The K candidate plans of s.cand ((K, H, nZ), visible to the block) through
// the horizon from x0 on the wide step (bodies.py::run_candidates at P=1):
// row k's costs in s.jt[k], s.jr[k]. Ends without a barrier, as
// wide_rollout (FX its).
template <int SC, bool GW, bool FX = false>
__device__ void cand_wide(const ApgArgs& a, const Smem& s, const float* wb, int K) {
  wide_rollout<SC, false, GW, false, FX>(a, s, wb, K, s.cand, a.H * a.nZ);
}

// Every block of the cluster: out(e, v) for e < n, v the sum over the
// chunks ch = 0 .. n_chunks-1, in that order, of element e of chunk ch's
// partial, part[(ch / cluster) * stride + e] in the shared memory of block
// ch % cluster (the blocks share one layout, so `part` is the same offset
// in each; stride, the partials' spacing, defaults to n). Opens with a
// cluster barrier (every partial written) and closes with one (no block
// overwrites a partial, or exits, while another still reads it).
template <class Out>
__device__ __forceinline__ void cluster_chunk_sum(const ApgArgs& a, float* part, int n,
                                                  Out out, int stride = 0) {
  cg::cluster_group cl = cg::this_cluster();
  const int ld = stride ? stride : n;
  cl.sync();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < a.n_chunks; ++ch)
      acc += cl.map_shared_rank(part, (unsigned)(ch % a.cluster))[(ch / a.cluster) * ld + e];
    out(e, acc);
  }
  cl.sync();
}


// The particle sweeps' Brownian block and starts: the pointer itself, or a
// source that returns it where a chunk starts (the scenario axis: the
// block of this scenario, offset there so that no register holds the
// offset pointer across the solve). A null start pointer: every row starts
// at the consts' x0.
__device__ __forceinline__ const float* noise_at(const float* noise) { return noise; }
template <class Src>
__device__ __forceinline__ const float* noise_at(const Src& src) { return src(); }

// The block's rank in its cluster, read from its special register where
// used (asm volatile: never hoisted, so no register holds it across a
// sweep), and the number of chunks the block sweeps (chunks rank, rank +
// cluster, ...).
__device__ __forceinline__ int block_rank_now() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// The spread (the header's note): a scenario's N = groups * cluster blocks
// are blocks b*N .. b*N + N-1 of the grid (at groups = 1 cluster b, whose
// ranks they are), the block index read from its special register where
// used.
__device__ __forceinline__ unsigned block_id_now() {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}
__device__ __forceinline__ int spread_blocks(const ApgArgs& a) { return a.groups * a.cluster; }
__device__ __forceinline__ size_t spread_scenario(const ApgArgs& a) {
  return block_id_now() / (unsigned)spread_blocks(a);
}
__device__ __forceinline__ int spread_rank(const ApgArgs& a) {
  return (int)(block_id_now() % (unsigned)spread_blocks(a));
}

// A block's first chunk and its chunks' stride, by the scenario's blocks:
// SPREAD its index among the scenario's N blocks and N, else its rank in
// its cluster and the cluster's size; and the number of chunks it sweeps.
template <bool SPREAD = false>
__device__ __forceinline__ int first_chunk(const ApgArgs& a) {
  if constexpr (SPREAD) return spread_rank(a);
  else return (int)cg::this_cluster().block_rank();
}
template <bool SPREAD = false>
__device__ __forceinline__ int chunk_stride(const ApgArgs& a) {
  if constexpr (SPREAD) return spread_blocks(a);
  else return a.cluster;
}
template <bool SPREAD = false>
__device__ __forceinline__ int block_chunks(const ApgArgs& a) {
  if constexpr (SPREAD)
    return (a.n_chunks - spread_rank(a) + spread_blocks(a) - 1) / spread_blocks(a);
  else return (a.n_chunks - block_rank_now() + a.cluster - 1) / a.cluster;
}
template <bool SPREAD = false>
__device__ __forceinline__ int rank_now(const ApgArgs& a) {
  if constexpr (SPREAD) return spread_rank(a);
  else return block_rank_now();
}

// The spread forms' set-up, by every thread before the block's first
// barrier: the block's Spread `sp` (shared memory) in s, no sum taken, and
// with groups > 1 this scenario's counter and slots in `scratch`
// (apg_solve.cuh spread_floats). units: the launch's spread units, each on
// groups * cluster blocks of its own (0: a.batch, one a scenario; the
// particle value_batch spreads each of its a.batch * K plans).
__device__ __forceinline__ void spread_init(const ApgArgs& a, Smem& s, Spread* sp,
                                            float* scratch, size_t units = 0) {
  s.sp = sp;
  if (threadIdx.x != 0) return;
  sp->nsum = 0;
  if (a.groups > 1) {
    const size_t b = spread_scenario(a);
    sp->arrive = reinterpret_cast<unsigned*>(scratch) + b * SPREAD_CTR;
    sp->slots = scratch + (units ? units : (size_t)a.batch) * SPREAD_CTR +
                b * 2 * (size_t)spread_region(a);
  }
}

// The barrier over the scenario's blocks before sum k = s.sp->nsum (its
// k+1-th): each block's thread 0 makes the block's writes visible, counts
// the block in and waits until all N blocks of each of the k+1 barriers are
// in (the counter starts at 0, zeroed before the launch); then nsum moves
// on. A scenario waits on its own blocks only.
__device__ __forceinline__ void spread_barrier(const ApgArgs& a, const Smem& s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    Spread* sp = s.sp;
    const unsigned target = (sp->nsum + 1u) * (unsigned)spread_blocks(a);
    __threadfence();
    atomicAdd(sp->arrive, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(sp->arrive) : "memory");
    } while (v < target);
    __threadfence();
    sp->nsum = sp->nsum + 1u;
  }
  __syncthreads();
}

// cluster_chunk_sum through device memory (groups > 1): the block copies
// its chunks' partials (chunk ch = first_chunk + jj * N at part[jj * stride
// ..]) to their slots of this sum's region, the barrier, then out(e, v) with
// v the sum of element e over the chunks' slots in chunk order
// 0 .. n_chunks-1, read past L1 (other blocks wrote them). Ends with a block
// barrier; the two regions alternate, so no slot is written again before
// every block has read it.
template <class Out>
__device__ void spread_chunk_sum(const ApgArgs& a, const Smem& s, const float* part,
                                              int n, Out out, int stride = 0) {
  const int ld = stride ? stride : n, N = spread_blocks(a), tid = threadIdx.x;
  __syncthreads();                                   // the block's partials written
  float* slot = s.sp->slots + (s.sp->nsum & 1u) * spread_region(a);
  for (int jj = 0, ch = spread_rank(a); ch < a.n_chunks; ++jj, ch += N)
    for (int e = tid; e < n; e += blockDim.x) __stcg(slot + (size_t)ch * n + e, part[jj * ld + e]);
  spread_barrier(a, s);
  for (int e = tid; e < n; e += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < a.n_chunks; ++ch) acc += __ldcg(slot + (size_t)ch * n + e);
    out(e, acc);
  }
  __syncthreads();
}

// The chunk sum of a sweep: SPREAD with groups > 1 through device memory,
// else through the cluster's distributed shared memory.
template <bool SPREAD = false, class Out>
__device__ __forceinline__ void chunk_sum(const ApgArgs& a, const Smem& s, float* part, int n,
                                          Out out, int stride = 0) {
  if constexpr (SPREAD) {
    if (a.groups > 1) {
      spread_chunk_sum(a, s, part, n, out, stride);
      return;
    }
  }
  cluster_chunk_sum(a, part, n, out, stride);
}

// Value and gradient of the iterate U over P particles (the noise branch of
// bodies.py::vg_sweep with its chunk loop, K11 :638-661), by every block of
// a cluster: per chunk of this block, Pc rows, a forward sweep into the
// state stash s.xs (H+1, Pc, 13) and the reverse sweep bwd_rows, the
// chunk's control gradient / n_chunks and its rows' mean costs / n_chunks
// into its partial (s.pg); then the partials of all chunks summed in chunk
// order (cluster_chunk_sum) into s.g and s.cacc[0..2), and the closed-form
// control gradient and the control-only terms added once. Every block ends
// with the same s.g and *fval. noise: the (H, P, 13) Brownian block, or a
// source that returns it (noise_at). OPT (the particle options): starts,
// the (P, 13) starts or null, or a source of them; with a.risk every
// chunk's forward comes first, then the two moments of the totals, then
// each chunk's reverse with the rows' risk weights (the header's Risk
// note). BF: the bf16 trunk. RM (OPT): RISK_MOMENTS_IN weighs the rows with
// the moments in s.red[6], s.red[7] after each chunk's own forward, and
// *fval is then the risk-free cost of this launch's particles. GW: the
// trunk's weights read from device memory (s.wg; trunk, bwd_rows). SPREAD
// (OPT): the chunks over the scenario's blocks and their sums through
// chunk_sum (the header's spread note).
template <int SC, bool PROF = false, bool OPT = false, bool BF = false,
          int RM = RISK_IN_CLUSTER, bool GW = false, bool SPREAD = false,
          class Noise = const float*, class Starts = const float*>
__device__ void vg_part(const ApgArgs& a, const Smem& s, float* fval, const float* U,
                        Noise noise, Starts starts) {
  static_assert(!SPREAD || OPT, "the spread is the options forms'");
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const float* c = s.c;
  constexpr bool IN = RM == RISK_MOMENTS_IN;     // the moments given: one pass
  const int HZ = a.H * a.nZ, R = a.Pc, W = HZ + 2 + (OPT && !IN && a.risk ? 1 : 0);
  const int rank = (int)cg::this_cluster().block_rank();
  if constexpr (!OPT) {
    for (int ch = rank, j = 0; ch < a.n_chunks; ch += a.cluster, ++j) {
      float* part = s.pg + j * W;
      for (int e = tid; e < R * 13; e += nt) {
        s.xs[e] = c[a.o_x0 + e % 13];
        s.ct[e] = 0.f;
      }
      for (int r = tid; r < R; r += nt) { s.jt[r] = 0.f; s.jr[r] = 0.f; }
      __syncthreads();
      const float* zc = noise_at(noise) + (size_t)ch * R * 13;
      for (int t = 0; t < a.H; ++t)
        fwd_step<true, SC, false, BF, GW>(a, s, R, U + t * a.nZ, 0, 1,
                                          zc + (size_t)t * a.P * 13, s.xs + t * R * 13,
                                          s.xs + (t + 1) * R * 13, t, nullptr, nullptr,
                                          GW ? s.wg : nullptr);
      prof_stamp<PROF>(s, PP_VG_FWD);
      for (int t = a.H - 1; t >= 0; --t)
        bwd_rows<SC, false, BF, GW>(a, s, U, zc + (size_t)t * a.P * 13, t, part);
      prof_stamp<PROF>(s, PP_VG_BWD);
      if (warp == 0) warp_reduce_to(R, [&](int r) { return s.jt[r]; }, s.red + 3);
      if (warp == 1) warp_reduce_to(R, [&](int r) { return s.jr[r]; }, s.red + 4);
      __syncthreads();
      if (tid == 0) {
        part[HZ] = s.red[3] / (float)R / (float)a.n_chunks;
        part[HZ + 1] = s.red[4] / (float)R / (float)a.n_chunks;
      }
    }
    cluster_chunk_sum(a, s.pg, W, [&](int e, float v) {
      if (e < HZ) s.g[e] = v;
      else s.cacc[e - HZ] = v;
    });
  } else {
    // One pass over the block's chunks (nj of them): without risk each
    // chunk's forward, costs and reverse; with risk 2 * nj steps, the
    // forwards (and totals) of chunks 0 .. nj-1, then the moments, then
    // the reverses of chunks nj-1 .. 0, each but the last forwarded one
    // run forward again first. Each sweep has one call site, and the step
    // `it` is the one value the loop keeps across a sweep: the chunk, its
    // partial and the block's chunk count are derived from it and the
    // block's rank, read from its special register where used
    // (block_chunks), and the scalars are read from shared memory. IN: one
    // step a chunk, as without risk.
    for (int it = 0; it < (!IN && a.risk ? 2 : 1) * block_chunks<SPREAD>(a); ++it) {
      if (!IN && a.risk && it == block_chunks<SPREAD>(a)) {
        // the tracking, sigma and total means, then the totals' centred
        // second moment, each in chunk order; the rows' weights in place
        // of their totals
        const int nj = block_chunks<SPREAD>(a);
        chunk_sum<SPREAD>(a, s, s.pg + HZ, 3, [&](int e, float v) { s.cacc[e] = v; }, W);
        for (int jj = 0; jj < nj; ++jj) {
          const float* tj = s.tot + jj * R;
          if (warp == 0)
            warp_reduce_to(R, [&](int r) { const float d = tj[r] - s.cacc[2]; return d * d; },
                           s.red + 6);
          __syncthreads();
          if (tid == 0) s.pg[jj * W + HZ] = s.red[6] / (float)R / (float)a.n_chunks;
          __syncthreads();
        }
        chunk_sum<SPREAD>(a, s, s.pg + HZ, 1, [&](int, float v) { s.red[7] = v; }, W);
        const float sd = sqrtf(s.red[7] + 1e-12f), lam = c[a.o_scal + SC_RISK];
        for (int e = tid; e < nj * R; e += nt)
          s.tot[e] = 1.f + lam * (s.tot[e] - s.cacc[2]) / sd;
        __syncthreads();
        if (tid == 0) s.cacc[0] = s.cacc[0] + lam * sd;
      }
      // the step's chunk: chunks 0 .. nj-1 forward, then (risk) nj-1 .. 0
      auto chunk_of = [&](int step) {
        const int nj = block_chunks<SPREAD>(a);
        return step < nj ? step : 2 * nj - 1 - step;
      };
      if (it < block_chunks<SPREAD>(a) || chunk_of(it) != block_chunks<SPREAD>(a) - 1) {
        // chunk ch's rows from their starts through the horizon into the
        // stash
        const int ch = rank_now<SPREAD>(a) + chunk_of(it) * chunk_stride<SPREAD>(a);
        const float* x0p = noise_at(starts);
        if (x0p) x0p += (size_t)ch * R * 13;
        for (int e = tid; e < R * 13; e += nt) {
          s.xs[e] = x0p ? x0p[e] : c[a.o_x0 + e % 13];
          s.ct[e] = 0.f;
        }
        for (int r = tid; r < R; r += nt) { s.jt[r] = 0.f; s.jr[r] = 0.f; }
        __syncthreads();
        const float* zc = noise_at(noise) + (size_t)ch * R * 13;
        for (int t = 0; t < a.H; ++t)
          fwd_step<true, SC, false, BF, GW>(a, s, R, U + t * a.nZ, 0, 1,
                                            zc + (size_t)t * a.P * 13, s.xs + t * R * 13,
                                            s.xs + (t + 1) * R * 13, t, nullptr, nullptr,
                                            GW ? s.wg : nullptr);
        prof_stamp<PROF>(s, PP_VG_FWD);
      }
      if (it < block_chunks<SPREAD>(a)) {
        // the chunk's rows' mean costs / n_chunks into part[HZ], part[HZ +
        // 1] (and with risk the rows' totals and their mean into
        // part[HZ + 2])
        if (!IN && a.risk) {
          float* tot = s.tot + it * R;
          for (int r = tid; r < R; r += nt) tot[r] = s.jt[r] + c[a.o_scal + SC_RESM] * s.jr[r];
          __syncthreads();
          if (warp == 2) warp_reduce_to(R, [&](int r) { return tot[r]; }, s.red + 5);
        }
        if (warp == 0) warp_reduce_to(R, [&](int r) { return s.jt[r]; }, s.red + 3);
        if (warp == 1) warp_reduce_to(R, [&](int r) { return s.jr[r]; }, s.red + 4);
        __syncthreads();
        if (tid == 0) {
          float* part = s.pg + it * W;
          part[HZ] = s.red[3] / (float)R / (float)a.n_chunks;
          part[HZ + 1] = s.red[4] / (float)R / (float)a.n_chunks;
          if (!IN && a.risk) part[HZ + 2] = s.red[5] / (float)R / (float)a.n_chunks;
        }
      }
      if (IN || !a.risk || it >= block_chunks<SPREAD>(a)) {
        const int j = chunk_of(it);
        if (a.risk) {
          // the chunk's risk weights where bwd_rows reads them (its
          // forward's running costs are spent; IN: made from them and the
          // given moments)
          if constexpr (IN) {
            const float m = s.red[6], sd = s.red[7], lam = c[a.o_scal + SC_RISK];
            for (int r = tid; r < R; r += nt)
              s.jt[r] = 1.f + lam * ((s.jt[r] + c[a.o_scal + SC_RESM] * s.jr[r]) - m) / sd;
          } else {
            for (int r = tid; r < R; r += nt) s.jt[r] = s.tot[j * R + r];
          }
          __syncthreads();
        }
        for (int t = a.H - 1; t >= 0; --t)
          bwd_rows<SC, true, BF, GW>(
              a, s, U,
              noise_at(noise) + (size_t)(rank_now<SPREAD>(a) + j * chunk_stride<SPREAD>(a)) * R * 13
                  + (size_t)t * a.P * 13,
              t, s.pg + chunk_of(it) * W);
        prof_stamp<PROF>(s, PP_VG_BWD);
      }
    }
    // the gradient (and without in-cluster risk the two costs) summed in
    // chunk order
    chunk_sum<SPREAD>(a, s, s.pg, !IN && a.risk ? HZ : W, [&](int e, float v) {
      if (e < HZ) s.g[e] = v;
      else s.cacc[e - HZ] = v;
    }, W);
  }
  prof_stamp<PROF>(s, PP_RED);
  for (int e = tid; e < HZ; e += nt) {
    const int t = e / a.nZ, i = e - t * a.nZ;
    s.g[e] = s.g[e] + ctrl_grad<SC>(a, c, U, t, i);
  }
  if (warp == 0) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).u; }, s.red + 0);
  if (warp == 1) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).sl; }, s.red + 1);
  if (warp == 2) warp_reduce_to(HZ, [&](int e) { return ctrl_terms<SC>(a, c, U, e).viol; }, s.red + 2);
  __syncthreads();
  if (tid == 0) {
    const float* scal = c + a.o_scal;
    float jc = scal[SC_UERR] * s.red[0] + scal[SC_SLEW] * s.red[1];
    if (a.has_slew) jc = jc + scal[SC_SLEWC] * s.red[2];
    *fval = s.cacc[0] + scal[SC_RESM] * s.cacc[1] + jc;
  }
  __syncthreads();
}

// K candidate plans (rows of s.cand, (K, H, nZ)) over P particles
// (bodies.py::candidate_rollout/run_candidates, :694-765), by every block of
// a cluster: per chunk of this block, K*Pc rows, particle-major (row i =
// p*K + k), through the horizon from x0 (OPT: from their particle's start,
// where starts are given), and each candidate's tracking and sigma means
// over the chunk's rows / n_chunks into the chunk's partial (s.pk); then the
// partials of all chunks summed in chunk order (cluster_chunk_sum): the
// particle mean of each candidate's costs, a mean of chunk means, in
// s.cacc[k] and s.cacc[K + k] of every block. With OPT and a.risk the
// partials carry the totals' means too (s.cacc[2K + k]), and a second
// ordered sum of the centred second moments adds lambda * std to s.cacc[k].
// The trunk's products are register tiles (fwd_step<true, SC, true>). The
// whole solve sweeps its K candidates at once; value_batch calls it with
// K = 1 (one candidate per cluster). BF: the bf16 trunk. RM (OPT):
// RISK_MOMENTS_OUT leaves the centred second moments in s.cacc[3K + k] and
// the tracking means without the risk term. GW: the trunk's weights read from
// device memory (s.wg; trunk). SPREAD: the chunks over the scenario's blocks
// and their sums through chunk_sum (the header's spread note; the whole
// solve's global-weight form, not value_batch's grid).
template <int SC, bool PROF = false, bool OPT = false, bool BF = false,
          int RM = RISK_IN_CLUSTER, bool GW = false, bool SPREAD = false,
          class Noise = const float*, class Starts = const float*>
__device__ void cand_part(const ApgArgs& a, const Smem& s, int K, Noise noise,
                          Starts starts) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int HZ = a.H * a.nZ, Pc = a.Pc, R = K * Pc;
  const int rank = first_chunk<SPREAD>(a);
  for (int ch = rank, j = 0; ch < a.n_chunks; ch += chunk_stride<SPREAD>(a), ++j) {
    if constexpr (OPT) {
      const float* x0p = noise_at(starts);
      if (x0p) x0p += (size_t)ch * Pc * 13;
      for (int e = tid; e < R * 13; e += nt)
        s.xr[e] = x0p ? x0p[(e / 13 / K) * 13 + e % 13] : s.c[a.o_x0 + e % 13];
    } else {
      for (int e = tid; e < R * 13; e += nt) s.xr[e] = s.c[a.o_x0 + e % 13];
    }
    for (int r = tid; r < R; r += nt) { s.jt[r] = 0.f; s.jr[r] = 0.f; }
    __syncthreads();
    const float* zc = noise_at(noise) + (size_t)ch * Pc * 13;
    for (int t = 0; t < a.H; ++t)
      fwd_step<true, SC, true, BF, GW>(a, s, R, s.cand + t * a.nZ, HZ, K,
                                       zc + (size_t)t * a.P * 13, s.xr, s.xr, t, nullptr,
                                       nullptr, GW ? s.wg : nullptr);
    prof_stamp<PROF>(s, PP_CAND);
    if (OPT && a.risk) {
      const float resm = s.c[a.o_scal + SC_RESM];
      for (int r = tid; r < R; r += nt) s.tot[j * R + r] = s.jt[r] + resm * s.jr[r];
      __syncthreads();
    }
    // the partial means per candidate: tracking, sigma (and the totals)
    if constexpr (OPT) {
      const int np = a.risk ? 3 : 2;
      if (tid < np * K) {
        const int kind = tid / K, k = tid - kind * K;
        const float* jr = kind == 0 ? s.jt : kind == 1 ? s.jr : s.tot + j * R;
        float acc = 0.f;
        for (int p = 0; p < Pc; ++p) acc += jr[p * K + k];
        s.pk[j * np * K + tid] = acc / (float)Pc / (float)a.n_chunks;
      }
    } else if (tid < 2 * K) {
      const int k = tid < K ? tid : tid - K;
      const float* jr = tid < K ? s.jt : s.jr;
      float acc = 0.f;
      for (int p = 0; p < Pc; ++p) acc += jr[p * K + k];
      s.pk[j * 2 * K + tid] = acc / (float)Pc / (float)a.n_chunks;
    }
    __syncthreads();
  }
  chunk_sum<SPREAD>(a, s, s.pk, (OPT && a.risk ? 3 : 2) * K,
                    [&](int e, float v) { s.cacc[e] = v; });
  if (OPT && a.risk) {
    for (int ch = rank, j = 0; ch < a.n_chunks; ch += chunk_stride<SPREAD>(a), ++j) {
      if (tid < K) {
        const float m = s.cacc[2 * K + tid];
        const float* tot = s.tot + j * R;
        float acc = 0.f;
        for (int p = 0; p < Pc; ++p) {
          const float d = tot[p * K + tid] - m;
          acc += d * d;
        }
        s.pk[j * K + tid] = acc / (float)Pc / (float)a.n_chunks;
      }
    }
    __syncthreads();
    // the tracking mean plus lambda * sqrt(var + 1e-12); moments out: var
    chunk_sum<SPREAD>(a, s, s.pk, K, [&](int e, float v) {
      if constexpr (RM == RISK_MOMENTS_OUT) s.cacc[3 * K + e] = v;
      else s.cacc[e] = s.cacc[e] + s.c[a.o_scal + SC_RISK] * sqrtf(v + 1e-12f);
    });
  }
  prof_stamp<PROF>(s, PP_RED);
}

// Let the particle form of a kernel take dynamic shared memory above the
// 48 KB default: up to APG_SMEM_LIMIT_PARTICLES (227 KB) less its static
// shared memory, the most the attribute accepts. Called once per library
// load (apg_init, cost_oracle_init).
template <class Kernel>
cudaError_t allow_large_smem(Kernel* fn) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              APG_SMEM_LIMIT_PARTICLES - (int)fa.sharedSizeBytes);
}

// A launch of `fn` as `clusters` clusters of C blocks (a grid of
// C * clusters blocks; cluster i is blocks i*C .. i*C + C-1) of `threads`
// threads with `dyn` bytes of dynamic shared memory each.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int C, int threads, size_t dyn, cudaStream_t st, int clusters = 1)
      : cfg(), attr() {
    cfg.gridDim = dim3(C * clusters);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = dyn;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// A launcher's result: the launch's own error, else cudaGetLastError()
// (which it clears).
inline int launch_error(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

// How many clusters of C blocks of `fn` (threads, dyn as above) the card
// can hold at once (cudaOccupancyMaxActiveClusters); 0 where none fits.
template <class Kernel>
cudaError_t max_active_clusters(Kernel* fn, int C, int threads, size_t dyn, int* n) {
  ClusterLaunch l(C, threads, dyn, nullptr);
  return cudaOccupancyMaxActiveClusters(n, (const void*)fn, &l.cfg);
}

// Let a particle form launch as a cluster of more than the portable 8
// blocks, and return in *cmax the largest it takes: CLUSTER_MAX (16) if the
// card schedules one such cluster at the form's block size and its largest
// dynamic shared memory (allow_large_smem first), else CLUSTER_PORTABLE.
// Called once per library load.
template <class Kernel>
cudaError_t cluster_max(Kernel* fn, int threads, int* cmax) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  int n = 0;
  const size_t dyn = (size_t)(APG_SMEM_LIMIT_PARTICLES - (int)fa.sharedSizeBytes);
  if (max_active_clusters(fn, CLUSTER_MAX, threads, dyn, &n) != cudaSuccess) {
    (void)cudaGetLastError();                // a size the card refuses: not an error here
    n = 0;
  }
  *cmax = n >= 1 ? CLUSTER_MAX : CLUSTER_PORTABLE;
  return cudaSuccess;
}

// Whether a particle launch's cluster fields are a plan of its chunks: C
// blocks a cluster, 1 <= C <= cmax, G = groups >= 1 of them a scenario (G
// > 1 only where `spread`, the spread forms), G * C <= n_chunks, each block
// at least one chunk and at most chunks_per_block.
inline bool cluster_args_ok(const ApgArgs& a, int cmax, bool spread = false) {
  const int n = a.groups * a.cluster;
  return a.cluster >= 1 && a.cluster <= cmax && a.groups >= 1 && (a.groups == 1 || spread) &&
         n <= a.n_chunks && a.chunks_per_block == (a.n_chunks + n - 1) / n;
}

// A spread launch (groups > 1; the header's spread note): the scenarios'
// arrival counters in `scratch` zeroed on the stream, then `fn` on a
// cooperative grid of batch * groups * cluster plain blocks of `threads`
// threads with `dyn` bytes of dynamic shared memory each, which the
// runtime refuses (its error returned) where the card cannot hold every
// block at once.
template <class... Params, class... Args>
cudaError_t launch_spread(void (*fn)(Params...), const ApgArgs& a, int threads, size_t dyn,
                          cudaStream_t st, float* scratch, Args... args) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, (size_t)a.batch * SPREAD_CTR * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3(a.batch * a.groups * a.cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, args...);
}

// How many blocks of `fn` (threads, dyn as above) the card holds at once:
// the bound of a spread launch's grid.
template <class Kernel>
cudaError_t resident_blocks(Kernel* fn, int threads, size_t dyn, int* n) {
  int per = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, threads, dyn);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *n = e == cudaSuccess ? per * sms : 0;
  return e;
}

}  // namespace
