// The cost oracle's particle global-weight forms (cost_oracle.cu;
// apg_solve.cuh, part_form): value_batch_kernel<true, SC, false, true, BF,
// RM, true> and value_and_grad_kernel<true, SC, true, BF, RM, P1_GLOBAL>,
// fp32 and bf16, in-cluster risk and the shared-moments forms, with the
// trunk's weights read in place from scenario 0's consts in device memory.
// cost_oracle.cu compiled with ORACLE_GW = 1 into a library of its own, which
// nvcc builds in parallel with cost_oracle.cu. Its entry points are
// cost_oracle.cu's; they launch only particle evaluations whose trunk and
// chunk take no shared-memory form of that kernel (the wrapper,
// ops/cuda/cost_oracle.py, picks the library by oracle_part_form) and refuse
// every other (trajectory among them). What bounds them is the trunk's
// FLOPs on the SMs a plan gets, then the weights' reads from L2, so
// value_and_grad's forms spread a scenario's chunks over ApgArgs::groups
// clusters' worth of blocks (sweeps.cuh, the spread note), their partials
// summed through device memory in chunk order: the bits of one cluster.
#define ORACLE_GW 1
#include "cost_oracle.cu"
