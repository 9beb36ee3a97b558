// Multi-view projected-IoU fitness of PST particles, for Hopper (sm_90a).
//
// Replaces the TPU kernel boxfusion_tpu/ops/fitness_kernel.py:
// _fitness_cell_body (launched by fitness_cells_pallas's pl.pallas_call).
// One cell is one (object x view); for every particle of a cell it computes
// err = |1 - IoU| * wmask, the IoU of the candidate's projected hull against
// the observed polygon, by the body in csrc/fitness_body.cuh (stages A-G).
// The arithmetic follows the Pallas body operation for operation (same
// tolerances, same tie rules, same summation order); the plain PyTorch twin
// is boxfusion_tpu_torch/ops/fitness_kernel.py:fitness_cells_reference.
// This is one PST iteration's fitness (multiview_fitness(impl="kernel")); the
// optimizer's main path runs the whole search in csrc/pst_search_kernel.cu,
// on the same body.
//
// Design for this card:
//  * One thread per (cell, particle), blocks of 256 particles of one cell,
//    grid (ceil(P / 256), C).  u, v arrive as (C, 8, P) float32,
//    particle-minor, so neighbouring threads read neighbouring addresses.
//  * The per-cell constants (observed hull 8x2, planes 12x3, pvalid 12,
//    area, wmask: 70 floats) are loaded once per block into shared memory.
//  * A masked cell (padded view slot, converged object) writes zeros and
//    returns, as _fitness_kernel does.
//  * Registers: the Pallas body keeps 28 planes x 5 values and a 28x8 side
//    cache live at once; the body here fuses stage F into stage A, so no
//    plane and no side value outlives its loop iteration (fitness_body.cuh).
//
// What bounds it: arithmetic.  A live particle-cell reads 64 bytes (8 u +
// 8 v floats) and writes 4, and does about 5 x 10^3 float32 operations
// (counted in ops/fitness_kernel.py:OPS_PER_LIVE_PARTICLE plus the valid-
// plane terms).  Built without FMA contraction, each counted operation is
// one instruction, and the H100 runs 33.5 x 10^12 float32 instructions a
// second (132 SMs x 128 lanes x 1.98 GHz; the data sheet's 67 TFLOP/s counts
// an FMA as two), so against its 3.35 TB/s the operations take ~7x longer
// than the bytes.  Skipping masked cells is the only data-dependent saving.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// --use_fast_math: IEEE division; no FMA contraction, so every product
// rounds on its own like the twin's) -- see ops/build.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fitness_body.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kObsPlanes = fitness::kObsPlanes;

__global__ void __launch_bounds__(kThreads)
fitness_cells_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ hull, const float* __restrict__ planes,
                     const float* __restrict__ pvalid, const float* __restrict__ area,
                     const float* __restrict__ wmask, float* __restrict__ out, int P) {
  __shared__ float s_hull[16];
  __shared__ float s_planes[3 * kObsPlanes];
  __shared__ float s_pvalid[kObsPlanes];
  __shared__ float s_area, s_wmask;

  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < 16) s_hull[tid] = hull[c * 16 + tid];
  if (tid < 3 * kObsPlanes) s_planes[tid] = planes[c * 3 * kObsPlanes + tid];
  if (tid < kObsPlanes) s_pvalid[tid] = pvalid[c * kObsPlanes + tid];
  if (tid == 0) {
    s_area = area[c];
    s_wmask = wmask[c];
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + tid;
  if (p >= P) return;
  const float wm = s_wmask;
  float* dst = out + (size_t)c * P + p;
  if (!(wm > 0.f)) {  // masked cell: skip the body, as _fitness_kernel does
    *dst = 0.f;
    return;
  }

  float U[8], V[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    U[k] = u[((size_t)c * 8 + k) * P + p];
    V[k] = v[((size_t)c * 8 + k) * P + p];
  }
  *dst = fitness::particle_error(U, V, s_hull, s_planes, s_pvalid, s_area) * wm;
}

}  // namespace

// C entry: launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fitness_cells_launch(const float* u, const float* v, const float* hull,
                                    const float* planes, const float* pvalid,
                                    const float* area, const float* wmask, float* out,
                                    int C, int P, void* stream) {
  if (C <= 0 || P <= 0) return (int)cudaSuccess;
  const dim3 grid((P + kThreads - 1) / kThreads, C);
  fitness_cells_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, v, hull, planes, pvalid, area, wmask, out, P);
  return (int)cudaGetLastError();
}
