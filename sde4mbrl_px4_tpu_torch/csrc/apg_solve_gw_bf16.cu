// The whole-solve kernel's particle global-weight forms on the bf16 trunk,
// apg_solve_kernel<true, SC, false, true, true, P1_GLOBAL> (apg_solve.cu;
// apg_solve.cuh, part_form): apg_solve.cu compiled with APG_GW = 1 and
// APG_BF16 = 1 into a library of its own, which nvcc builds in parallel with
// the others. Its entry points are apg_solve.cu's; they launch only particle
// solves with ApgArgs::bf16 = 1 whose trunk and chunk take no shared-memory
// form, and refuse every other. A batched launch reads scenario 0's trunk.
// Each scenario spreads over ApgArgs::groups clusters' worth of blocks
// (apg_solve.cu, the global-weight note).
#define APG_GW 1
#define APG_BF16 1
#include "apg_solve.cu"
