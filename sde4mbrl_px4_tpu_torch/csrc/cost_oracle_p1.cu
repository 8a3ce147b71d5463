// The cost oracle's P=1 forms (cost_oracle.cu): value_batch_kernel<false,
// SC, REG, false, BF, RISK_IN_CLUSTER, GW> on the register chain and on the
// shared-memory step (its weights in shared or device memory), fp32 and
// bf16; value_and_grad_kernel<false, SC, ..., STEP, FX> on the register
// chain and on the wide step (its weights in shared or device memory, over
// up to P1_FMAX trunk inputs or, FX, more); trajectory_kernel<REG, GW>.
// cost_oracle.cu compiled with ORACLE_P1 = 1 into a library of its own, which
// nvcc builds in parallel with cost_oracle.cu (the cluster particle forms)
// and cost_oracle_gw.cu (the particle global-weight forms). Its entry points
// are cost_oracle.cu's; they launch only P=1 evaluations (and every
// trajectory, the mean dynamics of a particle solve too) and refuse every
// other (the wrapper, ops/cuda/cost_oracle.py, picks the library by
// has_noise).
#define ORACLE_P1 1
#include "cost_oracle.cu"
