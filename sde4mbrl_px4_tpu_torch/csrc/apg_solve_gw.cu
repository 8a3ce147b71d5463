// The whole-solve kernel's particle global-weight forms in fp32,
// apg_solve_kernel<true, SC, false, true, false, P1_GLOBAL> (apg_solve.cu;
// apg_solve.cuh, part_form): apg_solve.cu compiled with APG_GW = 1 into a
// library of its own, which nvcc builds in parallel with apg_solve.cu. Its
// entry points are apg_solve.cu's; they launch only fp32 particle solves
// whose trunk and chunk take no shared-memory form (the wrapper,
// ops/cuda/apg_kernel.py, picks the library by apg_part_form) and refuse
// every other. A batched launch reads scenario 0's trunk.
// Each scenario spreads over ApgArgs::groups clusters' worth of blocks
// (apg_solve.cu, the global-weight note).
#define APG_GW 1
#include "apg_solve.cu"
