// ABI of the whole-solve APG kernel: the argument struct and the layout of
// its flat fp32 consts buffer. The Python mirror is
// sde4mbrl_px4_tpu_torch/ops/cuda/consts.py::ApgArgs (same field order;
// every field is 4 bytes, so there is no padding). apg_args_size() lets the
// wrapper check that both sides agree.
#pragma once

#define APG_MAXK 8          // largest maxls (linesearch candidates) supported
#define APG_NTHREADS 256    // threads per block (one block per solve)
#define APG_SMEM_LIMIT 49152  // static + dynamic shared memory budget (bytes)

struct ApgArgs {
  // dimensions
  int H, n_u, nZ, K, F, HID, OUT;
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
};

// scal block (o_scal): [mass, diff_scale, uerr, u_slew_coeff,
//                       u_slew_constr_coeff, res_mult]
enum { SC_MASS = 0, SC_DIFF = 1, SC_UERR = 2, SC_SLEW = 3, SC_SLEWC = 4,
       SC_RESM = 5 };
