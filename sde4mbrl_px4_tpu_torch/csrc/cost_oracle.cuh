// ABI of the cost-oracle kernels (cost_oracle.cu). They take the whole-solve
// kernel's argument struct and consts buffer (apg_solve.cuh::ApgArgs, packed
// by sde4mbrl_px4_tpu_torch/ops/cuda/consts.py::build_consts) and ignore its
// solver fields. cost_oracle_args_size() lets the wrapper check the struct.
#pragma once

#include "apg_solve.cuh"

#define ORACLE_NTHREADS 256     // threads per block
#define ORACLE_TILE 16          // candidate rows per value_batch block
#define ORACLE_SMEM_LIMIT 49152 // static + dynamic shared memory budget (bytes)

// Which kernel a shared-memory query is for.
enum { ORACLE_VALUE_BATCH = 0, ORACLE_TRAJECTORY = 1, ORACLE_VALUE_AND_GRAD = 2 };
