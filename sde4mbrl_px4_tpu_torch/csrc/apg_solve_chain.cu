// The whole-solve kernel's P=1 register chain, apg_solve_kernel<false, SC>
// and its clock-stamped form <false, CONSTR_NONE, true> (apg_solve.cu):
// apg_solve.cu compiled with APG_CHAIN = 1 into a library of its own, which
// nvcc builds in parallel with the others (apg_solve.cu keeps the fp32
// particle forms). Its entry points are apg_solve.cu's; they launch only P=1
// solves on a trunk of the register chain's widths (the wrapper,
// ops/cuda/apg_kernel.py, picks the library by them) and refuse every other.
#define APG_CHAIN 1
#include "apg_solve.cu"
