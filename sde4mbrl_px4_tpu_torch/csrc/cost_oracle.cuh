// ABI of the cost-oracle kernels (cost_oracle.cu). They take the whole-solve
// kernel's argument struct and consts buffer (apg_solve.cuh::ApgArgs, packed
// by sde4mbrl_px4_tpu_torch/ops/cuda/consts.py::build_consts) and ignore its
// solver fields. cost_oracle_args_size() lets the wrapper check the struct.
#pragma once

#include "apg_solve.cuh"

#define ORACLE_NTHREADS 256     // threads per block
#define ORACLE_NTHREADS_PART 512  // ... in the particle forms
// Candidate rows per P=1 value_batch block: one warp each on the register
// chain of the P=1 forms (trunks of its layout, P1_HID and F <= P1_FMAX);
// one thread each on the shared-memory step (other trunks).
#define ORACLE_P1_ROWS APG_MAXK
#define ORACLE_TILE 16
#define ORACLE_SMEM_LIMIT 49152 // static + dynamic shared memory budget (bytes), P=1 chain
// Budget of the particle forms (has_noise) and of the P=1 shared-memory
// step: all of a block's shared memory on sm_90 (227 KB), as dynamic shared
// memory (cost_oracle_init).
#define ORACLE_SMEM_LIMIT_PARTICLES APG_SMEM_LIMIT_PARTICLES

// Which kernel a shared-memory query is for.
enum { ORACLE_VALUE_BATCH = 0, ORACLE_TRAJECTORY = 1, ORACLE_VALUE_AND_GRAD = 2 };
