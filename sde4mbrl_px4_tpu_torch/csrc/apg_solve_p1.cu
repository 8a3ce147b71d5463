// The whole-solve kernel's P=1 forms on the wide step,
// apg_solve_kernel<false, SC, false, false, false, P1_SMEM / P1_GLOBAL>
// (apg_solve.cu; sweeps.cuh, vg_wide / cand_wide): apg_solve.cu compiled
// with APG_P1S = 1 into a library of its own, which nvcc builds in parallel
// with apg_solve.cu. Its entry points are apg_solve.cu's; they launch only
// P=1 solves on a trunk off the register chain's widths (the wrapper,
// ops/cuda/apg_kernel.py, picks the library by them) and refuse every other.
#define APG_P1S 1
#include "apg_solve.cu"
