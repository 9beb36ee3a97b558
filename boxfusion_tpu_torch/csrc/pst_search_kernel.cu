// The whole PST search of a batch of objects in one launch, for Hopper (sm_90a).
//
// Replaces the TPU program that runs the search on the chip:
// boxfusion_tpu/fusion/optimizer.py:optimize_boxes, a jax.vmap over objects
// of a lax.while_loop per object (`one`, its `body`), whose fitness is the
// Pallas kernel boxfusion_tpu/ops/fitness_kernel.py:fitness_cells_pallas
// (body _fitness_cell_body).  In eager PyTorch each iteration of that loop
// was ~100 launches around csrc/fitness_kernel.cu and one host read of the
// loop's flag; here the loop runs on the card.  Per object and iteration:
//   a) perturb the candidate by every PST particle (dims clamped >= 0.01),
//   b) its 8 corners (CORNER_SIGNS order, R local + centre),
//   c) into each live view's camera frame by the pose's transpose, z guarded
//      at 1e-9, uv clamped to [0, W] x [0, H] (fusion/kernel.py:
//      project_candidates), minus the view's centre,
//   d) the fitness body of csrc/fitness_body.cuh per (particle, view),
//   e) the mean over live views (summed in slot order, / (n_views + 1e-6)),
//   f) _cal_transform: particles better than particle 0, the first
//      max_contributors of them by index, their weighted mean,
//   g) _update_search_size, the beta EMA, fail count and done flag
//      (fusion/optimizer.py), leaving the loop once done or after `iters`.
// The plain PyTorch version is boxfusion_tpu_torch/ops/pst_search.py:
// pst_search_reference (the eager loop).
//
// Design for this card:
//  * One thread-block cluster per object, one CTA per 128 particles (8 CTAs,
//    the portable maximum, at P = 1024), one CTA an SM.  An inactive
//    object's cluster writes its initial box and returns at once.  The card
//    holds 15 such clusters at once, not 16 (they must fit its GPCs), so
//    cluster i takes the object of i-th highest load (live views): the one
//    that waits for a free slot is the lightest, and it finishes within the
//    heaviest's time.  Each CTA loads its PST rows, the object's rotation
//    and its live views' constants (observed hull, planes, area, centre,
//    pose: prepare_observed's output) into shared memory once.
//  * 512 threads: 128 particles x 4 view lanes.  Each iteration first puts
//    the world corners of the CTA's 128 candidates in shared memory (one
//    (corner, particle) item a thread), then deals out the (live view,
//    particle) items in order, so a warp works on one view and a dead view
//    slot costs nothing; 16 warps an SM hide the ALU latency of the long
//    dependent chains of the body, within 128 registers a thread.  Shared
//    arrays are component-major, so a warp's 32 particles read 32 banks.
//  * The reduction across the cluster reads other CTAs' shared memory
//    (DSMEM): after cluster barrier (1) every CTA reads particle 0's fitness
//    from CTA 0 and counts the better particles of the CTAs before it (the
//    offset of its ranks under the max_contributors cap), scans its own
//    flags (warp ballots), and reduces its 8 partial sums (sum w, sum
//    w pst[0..5], sum f w) in a fixed tree; after barrier (2) every CTA adds
//    the CTAs' partials in CTA order and computes the same scalar update, so
//    the whole cluster leaves the loop together.  Barrier (3) keeps every CTA
//    resident until no other one can still read its shared memory.  The
//    order of every sum is fixed: the result is the same from run to run.
//
// What bounds it: arithmetic.  Per iteration and live (view, particle) cell
// the body does ~5 x 10^3 float32 operations and the projection 264, and
// each particle's corners 336 more (ops/fitness_kernel.py:
// OPS_PER_LIVE_PARTICLE, ops/pst_search.py:CELL_OPS, PARTICLE_OPS); without
// FMA contraction each is one instruction, at 33.5 x 10^12 a second on the
// card.  The bytes (the inputs
// once, ~40 KB) are negligible.  An object's iterations run one after the
// other, so the launch lasts as long as its slowest object: iterations x
// live views x 128 bodies on each of its 8 SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// --use_fast_math), as the fitness kernel -- see ops/build.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fitness_body.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kParticles = 128;                // particles per CTA
constexpr int kLanes = 4;                      // view lanes per particle
constexpr int kThreads = kParticles * kLanes;  // 512
constexpr int kWarps = kParticles / 32;        // warps of the particle-level steps
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr int kMaxViews = 16;
constexpr int kMaxObjects = kThreads;          // one thread each when ordering them
constexpr int kSums = 8;  // sum w, sum w pst[0..5], sum f w

// one live view's constants in shared memory, in floats
constexpr int kHull = 0, kPlanes = 16, kPvalid = 52, kArea = 64, kCenter = 65, kPose = 67;
constexpr int kCellFloats = 79;  // hull 16, planes 36, pvalid 12, area 1, centre 2, pose rows 0-2: 12

struct Params {
  int N, V, iters, cap, fail_limit;
  float H, W;
  float ss0[2];   // initial search size: centre, shape
  float coef[2];  // scaling coefficient: centre, shape
  float beta, one_minus_beta, min_scale;
};

struct State {  // one object's search state, the same in every CTA of its cluster
  float x[6], ss[6], prev_ss[6];
  int prev_success, fail, need_update, done, it;
};

// a)-b): corner k of particle p's candidate (xyzlhw + pst * ss, dims
// clamped >= 0.01) in the world: R local + centre, local = sign * dims / 2 in
// CORNER_SIGNS order.  pst: (6, 128) this CTA's rows, component-major; R
// (3 x 3, row-major).
__device__ __forceinline__ void world_corner(const float* x, const float* ss, const float* pst,
                                             int p, int k, const float* R, float* w) {
  float c[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) c[d] = x[d] + pst[d * kParticles + p] * ss[d];
#pragma unroll
  for (int d = 3; d < 6; ++d) c[d] = fmaxf(c[d], 0.01f);
  const float hl = c[3] * 0.5f, hh = c[4] * 0.5f, hw = c[5] * 0.5f;
  const float lx = (((k + 1) >> 1) & 1) ? hl : -hl;
  const float ly = ((k >> 1) & 1) ? hh : -hh;
  const float lz = (k >> 2) ? hw : -hw;
  w[0] = R[0] * lx + R[1] * ly + R[2] * lz + c[0];
  w[1] = R[3] * lx + R[4] * ly + R[5] * lz + c[1];
  w[2] = R[6] * lx + R[7] * ly + R[8] * lz + c[2];
}

// c): the 8 world corners of one particle (world: (24, 128), component-major,
// column p) in one view: by the pose's transpose into the camera frame (pose:
// rows 0-2 of the 4 x 4 camera-to-world matrix), z guarded at 1e-9, pixel
// coordinates clamped to [0, W] x [0, H] (K = {K00, K02, K11, K12}), minus
// the view's centre.
__device__ __forceinline__ void project_particle(const float* world, int p, const float* pose,
                                                 const float* K, float H, float W,
                                                 const float* center, float (&U)[8],
                                                 float (&V)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float rx = world[(3 * k) * kParticles + p] - pose[3];
    const float ry = world[(3 * k + 1) * kParticles + p] - pose[7];
    const float rz = world[(3 * k + 2) * kParticles + p] - pose[11];
    const float cx = pose[0] * rx + pose[4] * ry + pose[8] * rz;
    const float cy = pose[1] * rx + pose[5] * ry + pose[9] * rz;
    float cz = pose[2] * rx + pose[6] * ry + pose[10] * rz;
    cz = fabsf(cz) < 1e-9f ? 1e-9f : cz;
    const float u = fminf(fmaxf(K[0] * cx / cz + K[1], 0.f), W);
    const float v = fminf(fmaxf(K[2] * cy / cz + K[3], 0.f), H);
    U[k] = u - center[0];
    V[k] = v - center[1];
  }
}

// g) one iteration's update from the cluster's sums (all[cta][k]), added in
// CTA order; f0 is particle 0's fitness.  Only called while not done.
__device__ void update_state(State& st, const float (*all)[kSums], int n_cta, float f0,
                             const Params& prm) {
  float tot[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    tot[k] = all[0][k];
    for (int q = 1; q < n_cta; ++q) tot[k] = tot[k] + all[q][k];
  }
  const bool success = tot[0] > 0.f;
  const float denom = success ? tot[0] : 1.f;
  const float iou = success ? tot[7] / denom : f0;
  float mt[6], s[6], nss[6];
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    mt[k] = success ? (tot[1 + k] / denom) * st.ss[k] : 0.f;
    s[k] = fabsf(mt[k]) + prm.min_scale;
    sq = k == 0 ? s[k] * s[k] : sq + s[k] * s[k];
  }
  const float norm = sqrtf(sq);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    nss[k] = prm.coef[k < 3 ? 0 : 1] * iou * (s[k] / norm) + prm.min_scale;
    if (st.prev_success && success)
      nss[k] = prm.beta * nss[k] + prm.one_minus_beta * st.prev_ss[k];
    if (success) {
      st.x[k] = st.x[k] + mt[k];
      st.prev_ss[k] = nss[k];
    }
    st.ss[k] = nss[k];
  }
  st.fail = success ? 0 : st.fail + 1;
  st.need_update = st.need_update || success;
  st.done = st.fail >= prm.fail_limit;
  st.prev_success = success;
  st.it += 1;
}

__global__ void __launch_bounds__(kThreads, 1)
pst_search_kernel(const float* __restrict__ x0, const float* __restrict__ rot,
                  const float* __restrict__ pst, const float* __restrict__ poses,
                  const float* __restrict__ Kmat, const bool* __restrict__ vmask,
                  const bool* __restrict__ active, const float* __restrict__ center,
                  const float* __restrict__ hull, const float* __restrict__ planes,
                  const float* __restrict__ pvalid, const float* __restrict__ area,
                  float* __restrict__ fused, bool* __restrict__ need_update,
                  int* __restrict__ iterations, const Params prm) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int V = prm.V;

  // The objects in order of falling load (live views; inactive ones last):
  // cluster i takes the i-th.  When the card holds fewer clusters than there
  // are objects, the ones that wait for a free slot are the lightest.
  __shared__ int s_load[kMaxObjects];
  __shared__ int s_obj;
  for (int t = tid; t < prm.N; t += kThreads) {
    int m = 0;
    for (int v = 0; v < V; ++v) m += vmask[t * V + v] ? 1 : 0;
    s_load[t] = active[t] ? m : -1;
  }
  __syncthreads();
  const int cl = blockIdx.x / n_cta;
  for (int t = tid; t < prm.N; t += kThreads) {
    int r = 0;
    for (int m = 0; m < prm.N; ++m)
      r += (s_load[m] > s_load[t] || (s_load[m] == s_load[t] && m < t)) ? 1 : 0;
    if (r == cl) s_obj = t;
  }
  __syncthreads();
  const int n = s_obj;

  if (!active[n]) {  // born converged: no iteration, the initial box comes back
    if (rank == 0 && tid < 6) fused[n * 6 + tid] = x0[n * 6 + tid];
    if (rank == 0 && tid == 0) {
      need_update[n] = false;
      iterations[n] = 0;
    }
    return;
  }

  __shared__ float s_cell[kMaxViews][kCellFloats];
  __shared__ float s_pst[6 * kParticles];     // (6, 128): this CTA's rows
  __shared__ float s_world[24 * kParticles];  // (8 corners x 3, 128)
  __shared__ float s_err[kMaxViews][kParticles];
  __shared__ float s_fit[kParticles];  // read by the other CTAs
  __shared__ float s_part[kSums];      // read by the other CTAs
  __shared__ float s_all[kMaxCluster][kSums];
  __shared__ float s_wsum[kWarps][kSums];
  __shared__ int s_wcount[kWarps];
  __shared__ float s_rot[9], s_K[4];
  __shared__ int s_live[kMaxViews];
  __shared__ int s_nlive;
  __shared__ State st;

  if (tid == 0) {
    int m = 0;
    for (int v = 0; v < V; ++v)
      if (vmask[n * V + v]) s_live[m++] = v;
    s_nlive = m;
    for (int k = 0; k < 6; ++k) {
      st.x[k] = x0[n * 6 + k];
      st.ss[k] = prm.ss0[k < 3 ? 0 : 1];
      st.prev_ss[k] = 0.f;
    }
    st.prev_success = 0;
    st.fail = 0;
    st.need_update = 0;
    st.done = 0;
    st.it = 0;
  }
  if (tid < 9) s_rot[tid] = rot[n * 9 + tid];
  if (tid < 4) s_K[tid] = Kmat[tid < 2 ? 2 * tid : tid + 2];  // K00, K02, K11, K12
  for (int i = tid; i < kParticles * 6; i += kThreads)
    s_pst[(i % 6) * kParticles + i / 6] = pst[(size_t)rank * kParticles * 6 + i];
  __syncthreads();
  const int nlive = s_nlive;
  for (int i = tid; i < nlive * kCellFloats; i += kThreads) {
    const int j = i / kCellFloats, k = i % kCellFloats;
    const size_t c = (size_t)n * V + s_live[j];
    float val;
    if (k < kPlanes) val = hull[c * 16 + k];
    else if (k < kPvalid) val = planes[c * 36 + (k - kPlanes)];
    else if (k < kArea) val = pvalid[c * fitness::kObsPlanes + (k - kPvalid)];
    else if (k == kArea) val = area[c];
    else if (k < kPose) val = center[c * 2 + (k - kCenter)];
    else val = poses[c * 16 + (k - kPose)];
    s_cell[j][k] = val;
  }
  __syncthreads();
  const float view_count = (float)nlive + 1e-6f;

  while (!st.done && st.it < prm.iters) {  // uniform: st changes only between barriers
    // a)-b) the world corners of this CTA's candidates, one (corner,
    // particle) item a thread
    for (int item = tid; item < 8 * kParticles; item += kThreads) {
      const int k = item / kParticles, p = item % kParticles;
      float w[3];
      world_corner(st.x, st.ss, s_pst, p, k, s_rot, w);
#pragma unroll
      for (int d = 0; d < 3; ++d) s_world[(3 * k + d) * kParticles + p] = w[d];
    }
    __syncthreads();
    // c)-d) every (live view, particle) item of this CTA
    for (int item = tid; item < nlive * kParticles; item += kThreads) {
      const int j = item / kParticles, p = item % kParticles;
      const float* cell = s_cell[j];
      float U[8], Vv[8];
      project_particle(s_world, p, cell + kPose, s_K, prm.H, prm.W, cell + kCenter, U, Vv);
      s_err[j][p] = fitness::particle_error(U, Vv, cell + kHull, cell + kPlanes, cell + kPvalid,
                                            cell[kArea]);
    }
    __syncthreads();
    // e) mean over the live views, summed in slot order
    if (tid < kParticles) {
      float s = 0.f;
      for (int j = 0; j < nlive; ++j) s = j == 0 ? s_err[0][tid] : s + s_err[j][tid];
      s_fit[tid] = s / view_count;
    }
    cluster.sync();  // (1) every CTA's fitness is in its s_fit

    // f) _cal_transform.  Ranks: better particles of the CTAs before this one
    // (read through DSMEM), then this CTA's own, in particle order.
    const float f0 = *cluster.map_shared_rank(&s_fit[0], 0);
    int offset = 0;
    for (int base = 0; base < rank * kParticles; base += kThreads) {
      const int g = base + tid;
      bool b = false;
      if (g > 0 && g < rank * kParticles)
        b = cluster.map_shared_rank(&s_fit[0], g / kParticles)[g % kParticles] < f0;
      offset += __syncthreads_count(b);
    }
    float f = 0.f;
    bool better = false;
    unsigned ballot = 0;
    if (tid < kParticles) {
      f = s_fit[tid];
      better = (rank > 0 || tid > 0) && f < f0;
      ballot = __ballot_sync(0xffffffffu, better);
      if ((tid & 31) == 0) s_wcount[tid >> 5] = __popc(ballot);
    }
    __syncthreads();
    if (tid < kParticles) {
      int r = offset + __popc(ballot & (0xffffffffu >> (31 - (tid & 31))));  // inclusive
      for (int q = 0; q < (tid >> 5); ++q) r += s_wcount[q];
      const float w = (better && r <= prm.cap) ? f0 - f : 0.f;
      float vals[kSums];
      vals[0] = w;
#pragma unroll
      for (int k = 0; k < 6; ++k) vals[1 + k] = s_pst[k * kParticles + tid] * w;
      vals[7] = f * w;
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) vals[k] += __shfl_xor_sync(0xffffffffu, vals[k], off);
      }
      if ((tid & 31) == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) s_wsum[tid >> 5][k] = vals[k];
      }
    }
    __syncthreads();
    if (tid < kSums) {
      float s = s_wsum[0][tid];
      for (int q = 1; q < kWarps; ++q) s = s + s_wsum[q][tid];
      s_part[tid] = s;
    }
    cluster.sync();  // (2) every CTA's partial sums are in its s_part
    if (tid < n_cta * kSums)
      s_all[tid / kSums][tid % kSums] = cluster.map_shared_rank(&s_part[0], tid / kSums)[tid % kSums];
    __syncthreads();
    if (tid == 0) update_state(st, s_all, n_cta, f0, prm);
    __syncthreads();
  }
  cluster.sync();  // (3) no CTA leaves while another may still read its s_part

  if (rank == 0 && tid < 6) {
    const float xk = st.x[tid];
    fused[n * 6 + tid] = st.need_update ? (tid < 3 ? xk : fmaxf(xk, 0.01f)) : x0[n * 6 + tid];
  }
  if (rank == 0 && tid == 0) {
    need_update[n] = st.need_update;
    iterations[n] = st.it;
  }
}

// The one layout the kernel takes (ops/pst_search.py:plan_pst_search): a
// cluster of P / 128 CTAs per object, 512 threads each, V <= 16 view slots,
// N <= 512 objects.
bool layout_ok(int N, int V, int P, int cluster, int threads) {
  return P % kParticles == 0 && cluster == P / kParticles && cluster >= 1 &&
         cluster <= kMaxCluster && threads == kThreads && V >= 1 && V <= kMaxViews &&
         N >= 0 && N <= kMaxObjects;
}

cudaLaunchConfig_t launch_config(int N, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// C entry.  Device pointers: x0 (N, 6), rot (N, 3, 3), pst (P, 6), poses
// (N, V, 4, 4), K (3, 3), vmask (N, V) bool, active (N,) bool, and
// prepare_observed's center (N V, 2), hull (N V, 8, 2), planes (N V, 12, 3),
// pvalid (N V, 12), area (N V); out: fused (N, 6), need_update (N,) bool,
// iterations (N,) int32.  All float32 and contiguous.  cluster and threads
// are plan_pst_search's; any other layout is refused (cudaErrorInvalidValue).
// Launches on `stream`; returns the cudaError_t of the launch (0 = launched).
extern "C" int pst_search_launch(const float* x0, const float* rot, const float* pst,
                                 const float* poses, const float* K, const void* vmask,
                                 const void* active, const float* center, const float* hull,
                                 const float* planes, const float* pvalid, const float* area,
                                 float* fused, void* need_update, int* iterations, int N, int V,
                                 int P, int cluster, int threads, int iters, int cap,
                                 int fail_limit, float H, float W, float ss0_center,
                                 float ss0_shape, float coef_center, float coef_shape,
                                 float beta, float one_minus_beta, float min_scale,
                                 void* stream) {
  if (!layout_ok(N, V, P, cluster, threads)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  Params prm;
  prm.N = N;
  prm.V = V;
  prm.iters = iters;
  prm.cap = cap;
  prm.fail_limit = fail_limit;
  prm.H = H;
  prm.W = W;
  prm.ss0[0] = ss0_center;
  prm.ss0[1] = ss0_shape;
  prm.coef[0] = coef_center;
  prm.coef[1] = coef_shape;
  prm.beta = beta;
  prm.one_minus_beta = one_minus_beta;
  prm.min_scale = min_scale;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(N, cluster, (cudaStream_t)stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pst_search_kernel, x0, rot, pst, poses, K, (const bool*)vmask, (const bool*)active,
      center, hull, planes, pvalid, area, fused, (bool*)need_update, iterations, prm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator say of the kernel at
// plan_pst_search's layout for P particles: info = {registers per thread,
// local (spill + stack) bytes per thread, static shared bytes per CTA,
// threads per CTA, CTAs per cluster, clusters resident on the card at once}.
// Returns a cudaError_t.
extern "C" int pst_search_info(int P, int* info) {
  if (P % kParticles != 0 || P / kParticles < 1 || P / kParticles > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int cluster = P / kParticles;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, pst_search_kernel);
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg = launch_config(cluster, cluster, 0, la);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, pst_search_kernel, &cfg);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = kThreads;
  info[4] = cluster;
  info[5] = clusters;
  return (int)err;
}
