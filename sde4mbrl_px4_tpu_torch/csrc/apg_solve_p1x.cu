// The whole-solve kernel's P=1 forms on the wide step over trunks of more
// than P1_FMAX inputs (9 + n_u > 16: eight motors or more),
// apg_solve_kernel<false, SC, false, false, false, P1_SMEM / P1_GLOBAL, true>
// (apg_solve.cu; sweeps.cuh, wide_rollout / wide_reverse with FX): layer 0
// reads the inputs past P1_FMAX from the row's controls, the wrench and its
// cotangent sum all n_u controls, and layer 0's transpose runs P1_FMAX
// inputs at a time, so the forms of up to 16 inputs (apg_solve_p1.cu) keep
// their code. apg_solve.cu compiled with APG_P1X = 1 into a library of its
// own, which nvcc builds in parallel with the others. Its entry points are
// apg_solve.cu's; they launch only P=1 solves on a trunk off the register
// chain's widths with more than P1_FMAX inputs (the wrapper,
// ops/cuda/apg_kernel.py, picks the library by them) and refuse every other.
#define APG_P1X 1
#include "apg_solve.cu"
