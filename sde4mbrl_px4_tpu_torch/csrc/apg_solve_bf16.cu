// The whole-solve kernel's bf16-trunk particle forms,
// apg_solve_kernel<true, SC, false, OPT, true> (apg_solve.cu, "Reduced
// matmul precision"): apg_solve.cu compiled with APG_BF16 = 1 into a
// library of its own, which nvcc builds in parallel with apg_solve.cu. Its
// entry points are apg_solve.cu's; they launch only particle solves with
// ApgArgs::bf16 = 1 (the wrapper, ops/cuda/apg_kernel.py, picks the
// library by it) and refuse every other.
#define APG_BF16 1
#include "apg_solve.cu"
