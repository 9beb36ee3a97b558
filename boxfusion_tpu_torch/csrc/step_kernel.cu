// The keyframe step's two serial loops, each in one launch of one thread
// block, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  On a TPU the JAX step (boxfusion_tpu/runtime/
// device_step.py: _nms_greedy's lax.while_loop, _correspondence's fori_loop)
// is one compiled program whose loop predicates stay on the chip.  In eager
// PyTorch the same loops (ops/step_kernel.py: nms_greedy_reference,
// correspond_hits_reference, the plain twins) run on the host: one counted
// read per NMS survivor pick and per correspondence count, and each
// suppression record or correspondence hit is ~60 small launches
// (runtime/device_step.py:_record_core), while the card idles.  Here the
// manager bookkeeping of the reference (instances.py:22-101,
// box_manager.py:40-129) runs on the card, in the twin's order:
//
//   nms_greedy_kernel: repeat { pick the remaining slot of the largest
//     score, ties to the larger slot (_argmax_score_desc); suppress the
//     remaining slots whose cached IoU in the pick's row exceeds the
//     threshold; valid_num / success of the pick; replay each suppressed
//     slot's record in score-descending order } until no slot remains.
//   correspond_hits_kernel: the hits of the correspondence pass (todo,
//     best, new_wins from _corr_plan) in ascending slot order: the loser's
//     keep off, the winner's valid_num + 1, then its record.
//
// One __device__ body, `record`, does what _record_core does: case A
// (append and sorted insert, capped at 5 members), case B (merge of two
// sorted rows, truncated to V, with the truncation count), the keep-swap
// and fflag; members_differ over _pose_differs (baseline norm, the trace of
// the relative rotation, acos in degrees, against translation_gap and
// rotation_gap) and record's centre-distance escape (norm > 0.5).
//
// Design for this card: what bounds it is latency, not bytes or FLOPs.  A
// keyframe is a serial chain of ~10 picks and ~100 records, each a few
// dependent global reads and one warp's shuffles.  So one block of 512
// threads: the picks' argmax, the IoU row pass and the rank sort of the
// suppressed slots use every thread (the remaining flags, the scores and
// the pick's lists live in shared memory), and the records run on warp 0,
// one lane per view slot (a member's pose test each, a vote, a sort of the
// row by ranks over shuffles).  No host read, and no launch per record.
//
// Arithmetic: float32, as the twin.  The library is built with -fmad=false;
// where the twin's torch operation contracts a multiply and an add, the
// body says fmaf.  The orders below are those of PyTorch's own operations on
// the card, found by a bit check over 10^5 pose pairs (PERF.md);
// step_pose_bits writes the kernels' own terms so that the check can be
// repeated (chip_smoke.py:pose_bit_shares).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxViews = 16;        // view slots a row (one lane each)
constexpr int kMaxCapacity = 16384;  // world slots: 13 B each of shared memory
constexpr int kMemberCap = 5;        // box_manager.py: a list grows only below 5
constexpr int kPadId = 1 << 30;      // runtime/device_state.py:PAD_ID
constexpr unsigned kFull = 0xffffffffu;
// (180 / pi) as the twin's float32 multiply sees it: the double quotient, rounded
constexpr float kDegrees = static_cast<float>(180.0 / 3.141592653589793);

// |(x, y, z)| as torch.linalg.norm reduces three squares on the card:
// (x^2 + z^2) + y^2.  The pose baseline and the centre distance.
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}

// A row of R_ref R_m^T's diagonal as cuBLAS computes it at K = 3: the
// second product fused into the first, then the third added.
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fmaf(a[1], b[1], a[0] * b[0]) + a[2] * b[2];
}

// _pose_differs' baseline: |t_m - t_ref| of two row-major 4x4 poses.
__device__ __forceinline__ float baseline(const float* pm, const float* pr) {
  return norm3(pm[3] - pr[3], pm[7] - pr[7], pm[11] - pr[11]);
}

// _pose_differs' trace of R_ref R_m^T: diagonal i is row i of R_ref dotted
// with row i of R_m, summed in order.
__device__ __forceinline__ float rel_trace(const float* pm, const float* pr) {
  return (dot3(pr, pm) + dot3(pr + 4, pm + 4)) + dot3(pr + 8, pm + 8);
}

// arccos(clamp((trace - 1) / 2, -1, 1)) in degrees; a NaN passes the clamp.
__device__ __forceinline__ float angle_deg(float trace) {
  float c = (trace - 1.0f) * 0.5f;
  c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
  return acosf(c) * kDegrees;
}

struct Gaps {
  float translation;
  float rotation;
};

__device__ __forceinline__ bool pose_differs(const float* pm, const float* pr, Gaps gaps) {
  return baseline(pm, pr) > gaps.translation || angle_deg(rel_trace(pm, pr)) > gaps.rotation;
}

// The mutable fields a record writes (the kernels' outputs).
struct Fields {
  int* flist;  // (G, V)
  int* fcount;
  bool* fflag;
  bool* keep;
};

struct Store {
  const float* obs_pose;  // (M, 4, 4)
  const int* init_id;     // (G,)
  int M;
  int V;
  Gaps gaps;
};

__device__ __forceinline__ int clamp_id(int id, int M) { return id < 0 ? 0 : (id > M - 1 ? M - 1 : id); }

// members_differ: every live member of `row` (this lane's entry `member`,
// `count` members) was seen from a pose that differs from `pose_ref`, or
// `extra`.  Slots past `count` vote true.  Warp-wide, all lanes.
__device__ __forceinline__ bool members_differ(int member, int count, const float* pose_ref,
                                               bool extra, const Store& st, int lane) {
  bool differs = true;
  if (!extra && lane < st.V && lane < count)
    differs = pose_differs(st.obs_pose + 16 * (size_t)clamp_id(member, st.M), pose_ref, st.gaps);
  return __all_sync(kFull, differs);
}

// Position of this lane's value among the V values `x` of lanes 0..V-1 in
// ascending order, ties by lane (torch.sort's values).
__device__ __forceinline__ int rank_of(int x, int V, int lane) {
  int rank = 0;
  for (int u = 0; u < V; ++u) {
    const int xu = __shfl_sync(kFull, x, u);
    rank += (xu < x) || (xu == x && u < lane);
  }
  return rank;
}

// _record_core: suppressed (or merged) slot j against survivor i, on warp 0.
// Writes rows i and j of the fields; returns the truncated-member count.
__device__ int record(const Fields& f, const Store& st, int i, int j, bool extra, int lane) {
  const int V = st.V;
  __syncwarp();
  const int cnt_i = f.fcount[i], cnt_j = f.fcount[j];
  const int row_i = lane < V ? f.flist[(size_t)i * V + lane] : kPadId;
  const int row_j = lane < V ? f.flist[(size_t)j * V + lane] : kPadId;
  const bool keep_i = f.keep[i], keep_j = f.keep[j];
  const bool flag_i = f.fflag[i], flag_j = f.fflag[j];
  const bool is_single = cnt_j == 1;
  int trunc = 0;
  bool do_swap = false;
  if (is_single) {
    // case A: j is a fresh observation; append its init_id to i's list
    if (cnt_i < kMemberCap) {
      const int id_j = st.init_id[j];
      const float* pose_j = st.obs_pose + 16 * (size_t)clamp_id(id_j, st.M);
      if (members_differ(row_i, cnt_i, pose_j, extra, st, lane)) {
        // _insert_sorted: written at min(count, V - 1), then the row sorted
        const int at = cnt_i < V - 1 ? cnt_i : V - 1;
        const int x = lane == at ? id_j : row_i;
        const int r = rank_of(x, V, lane);
        __syncwarp();
        if (lane < V) f.flist[(size_t)i * V + r] = x;
        if (lane == 0) f.fcount[i] = cnt_i + 1;
      }
    }
  } else {
    // case B: j is a multi-view box; merge its list into i's, or swap keeps
    const float* pose_i = st.obs_pose + 16 * (size_t)clamp_id(st.init_id[i], st.M);
    const bool mergeable = cnt_j < kMemberCap && members_differ(row_j, cnt_j, pose_i, extra, st, lane);
    if (mergeable) {
      // _merge_sorted: the V smallest of the 2V entries, ascending (ties:
      // row i's entries first, as in torch.cat then sort)
      int ra = 0, rb = 0;
      for (int u = 0; u < V; ++u) {
        const int au = __shfl_sync(kFull, row_i, u), bu = __shfl_sync(kFull, row_j, u);
        ra += (au < row_i) || (au == row_i && u < lane);
        ra += bu < row_i;
        rb += au <= row_j;
        rb += (bu < row_j) || (bu == row_j && u < lane);
      }
      __syncwarp();
      if (lane < V && ra < V) f.flist[(size_t)i * V + ra] = row_i;
      if (lane < V && rb < V) f.flist[(size_t)i * V + rb] = row_j;
      const int total = cnt_i + cnt_j;
      if (lane == 0) f.fcount[i] = total < V ? total : V;
      trunc = total - V > 0 ? total - V : 0;
    } else {
      do_swap = keep_i;  // the old multi-view box wins over the survivor
    }
  }
  if (lane == 0) {
    f.keep[i] = keep_i && !do_swap;
    f.keep[j] = keep_j || do_swap;
    f.fflag[i] = flag_i || (!is_single && flag_j);
  }
  __syncwarp();
  return trunc;
}

// The score order of _argmax_score_desc as one 64-bit key: the score's
// bits made monotone (-0 taken as +0, as == takes them), then slot + 1.
__device__ __forceinline__ unsigned long long score_key(float score, int slot) {
  const unsigned u = __float_as_uint(score + 0.0f);
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ordered << 32) | (unsigned)(slot + 1);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

struct NmsArgs {
  const float* scores;    // (G,)
  const float* iou;       // (G, G)
  const bool* contested;  // (G,)
  const bool* isolated;   // (G,)
  const int* flist;       // (G, V)
  const int* fcount;
  const bool* fflag;
  const float* valid_num;
  const float* xyzlhw;  // (G, 6)
  bool* keep;           // outputs
  bool* success;
  float* valid_num_out;
  int* trunc;
  long long* tally;  // (3,) picks, records, hits
  Fields out;
  Store st;
  int G;
  float threshold;
};

__global__ void __launch_bounds__(kThreads, 1) nms_greedy_kernel(const NmsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G, V = a.st.V;
  float* score = reinterpret_cast<float*>(smem);  // G
  int* supp = reinterpret_cast<int*>(score + G);  // G: this pick's suppressed slots
  int* order = supp + G;                          // G: the same in record order
  unsigned char* remaining = reinterpret_cast<unsigned char*>(order + G);  // G
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ int pick, n_supp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int s = tid; s < G; s += kThreads) {
    score[s] = a.scores[s];
    remaining[s] = a.contested[s];
    a.keep[s] = a.isolated[s];
    a.success[s] = false;
    a.out.fcount[s] = a.fcount[s];
    a.out.fflag[s] = a.fflag[s];
    a.valid_num_out[s] = a.valid_num[s];
  }
  for (int e = tid; e < G * V; e += kThreads) a.out.flist[e] = a.flist[e];
  __syncthreads();

  int trunc = 0;
  long long picks = 0, records = 0;
  for (;;) {
    // the pick: the largest score among the remaining slots, ties to the larger slot
    unsigned long long best = 0;
    for (int s = tid; s < G; s += kThreads)
      if (remaining[s]) {
        const unsigned long long k = score_key(score[s], s);
        best = k > best ? k : best;
      }
    best = warp_max(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_max(lane < kWarps ? warp_best[lane] : 0ull);
      if (lane == 0) {
        pick = best ? (int)(best & 0xffffffffu) - 1 : -1;
        n_supp = 0;
      }
    }
    __syncthreads();
    const int i = pick;
    if (i < 0) break;

    // the pick's row of the cache: the remaining slots it suppresses
    const float* row = a.iou + (size_t)i * G;
    for (int s = tid; s < G; s += kThreads)
      if (s != i && remaining[s] && row[s] > a.threshold) {
        remaining[s] = 0;
        supp[atomicAdd(&n_supp, 1)] = s;
      }
    __syncthreads();
    const int n = n_supp;
    if (tid == 0) {
      remaining[i] = 0;
      a.keep[i] = true;
      a.valid_num_out[i] = a.valid_num_out[i] + (n > 0 ? 1.0f : 0.0f);
      a.success[i] = a.success[i] || n > 0;
    }
    // the records' order: score descending, ties to the larger slot (a rank each)
    for (int k = tid; k < n; k += kThreads) {
      const int s = supp[k];
      const unsigned long long key = score_key(score[s], s);
      int rank = 0;
      for (int m = 0; m < n; ++m) rank += score_key(score[supp[m]], supp[m]) > key;
      order[rank] = s;
    }
    __syncthreads();
    if (warp == 0) {
      const float* ci = a.xyzlhw + 6 * (size_t)i;
      for (int r = 0; r < n; ++r) {
        const int j = order[r];
        const float* cj = a.xyzlhw + 6 * (size_t)j;
        const bool far = norm3(ci[0] - cj[0], ci[1] - cj[1], ci[2] - cj[2]) > 0.5f;
        trunc += record(a.out, a.st, i, j, far, lane);
      }
    }
    ++picks;
    records += n;
    __syncthreads();
  }
  if (tid == 0) {
    *a.trunc = trunc;
    atomicAdd(reinterpret_cast<unsigned long long*>(a.tally), (unsigned long long)picks);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.tally + 1), (unsigned long long)records);
  }
}

struct CorrArgs {
  const bool* todo;       // (G,)
  const long long* best;  // (G,)
  const bool* new_wins;   // (G,)
  const bool* keep;       // (G,)
  const int* flist;
  const int* fcount;
  const bool* fflag;
  const float* valid_num;
  float* valid_num_out;  // outputs
  int* trunc;
  long long* tally;
  Fields out;
  Store st;
  int G;
};

__global__ void __launch_bounds__(kThreads, 1) correspond_hits_kernel(const CorrArgs a) {
  const int G = a.G, V = a.st.V;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int s = tid; s < G; s += kThreads) {
    a.out.keep[s] = a.keep[s];
    a.out.fcount[s] = a.fcount[s];
    a.out.fflag[s] = a.fflag[s];
    a.valid_num_out[s] = a.valid_num[s];
  }
  for (int e = tid; e < G * V; e += kThreads) a.out.flist[e] = a.flist[e];
  __syncthreads();
  if (tid >= 32) return;

  // the hits in ascending slot order (_corr_body: the lowest slot still to do)
  int trunc = 0;
  long long hits = 0;
  for (int base = 0; base < G; base += 32) {
    unsigned pending = __ballot_sync(kFull, base + lane < G && a.todo[base + lane]);
    while (pending) {
      const int s = base + __ffs(pending) - 1;
      pending &= pending - 1;
      const int b = (int)a.best[s];
      const bool wins = a.new_wins[s];
      const int cur = wins ? s : b, other = wins ? b : s;
      if (lane == 0) {
        a.out.keep[other] = false;
        a.valid_num_out[cur] = a.valid_num_out[cur] + 1.0f;
      }
      trunc += record(a.out, a.st, cur, other, false, lane);
      ++hits;
    }
  }
  if (lane == 0) {
    *a.trunc = trunc;
    atomicAdd(reinterpret_cast<unsigned long long*>(a.tally + 2), (unsigned long long)hits);
  }
}

size_t nms_smem_bytes(int G) { return (size_t)G * (3 * sizeof(int) + 1); }

bool layout_ok(int G, int V, int M) {
  return G >= 1 && G <= kMaxCapacity && V >= 1 && V <= kMaxViews && M >= 1;
}

Store make_store(const float* obs_pose, const int* init_id, int M, int V, float translation_gap,
                 float rotation_gap) {
  Store st;
  st.obs_pose = obs_pose;
  st.init_id = init_id;
  st.M = M;
  st.V = V;
  st.gaps.translation = translation_gap;
  st.gaps.rotation = rotation_gap;
  return st;
}

// step_pose_bits' outputs per pose pair
constexpr int kBitsWidth = 4;

__global__ void pose_bits_kernel(const float* pm, const float* pr, int N, Gaps gaps, float* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* m = pm + 16 * (size_t)n;
  const float* r = pr + 16 * (size_t)n;
  float* o = out + kBitsWidth * (size_t)n;
  const float trace = rel_trace(m, r);
  o[0] = baseline(m, r);
  o[1] = trace;
  o[2] = angle_deg(trace);
  o[3] = pose_differs(m, r, gaps) ? 1.0f : 0.0f;
}

}  // namespace

// nms_greedy (ops/step_kernel.py): the greedy NMS of one keyframe, one block.
// Returns a cudaError_t.
extern "C" int step_nms_greedy_launch(const float* scores, const float* iou, const void* contested,
                                      const void* isolated, const int* flist, const int* fcount,
                                      const void* fflag, const float* valid_num, const float* xyzlhw,
                                      const float* obs_pose, const int* init_id, void* keep,
                                      void* success, int* flist_out, int* fcount_out,
                                      void* fflag_out, float* valid_num_out, int* trunc,
                                      long long* tally, int G, int V, int M, float threshold,
                                      float translation_gap, float rotation_gap, void* stream) {
  if (!layout_ok(G, V, M)) return (int)cudaErrorInvalidValue;
  NmsArgs a;
  a.scores = scores;
  a.iou = iou;
  a.contested = (const bool*)contested;
  a.isolated = (const bool*)isolated;
  a.flist = flist;
  a.fcount = fcount;
  a.fflag = (const bool*)fflag;
  a.valid_num = valid_num;
  a.xyzlhw = xyzlhw;
  a.keep = (bool*)keep;
  a.success = (bool*)success;
  a.valid_num_out = valid_num_out;
  a.trunc = trunc;
  a.tally = tally;
  a.out.flist = flist_out;
  a.out.fcount = fcount_out;
  a.out.fflag = (bool*)fflag_out;
  a.out.keep = (bool*)keep;
  a.st = make_store(obs_pose, init_id, M, V, translation_gap, rotation_gap);
  a.G = G;
  a.threshold = threshold;
  const size_t smem = nms_smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_greedy_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// correspond_hits (ops/step_kernel.py): the correspondence pass's hits, one
// block.  Returns a cudaError_t.
extern "C" int step_correspond_hits_launch(const void* todo, const long long* best,
                                           const void* new_wins, const void* keep, const int* flist,
                                           const int* fcount, const void* fflag,
                                           const float* valid_num, const float* obs_pose,
                                           const int* init_id, void* keep_out, int* flist_out,
                                           int* fcount_out, void* fflag_out, float* valid_num_out,
                                           int* trunc, long long* tally, int G, int V, int M,
                                           float translation_gap, float rotation_gap, void* stream) {
  if (!layout_ok(G, V, M)) return (int)cudaErrorInvalidValue;
  CorrArgs a;
  a.todo = (const bool*)todo;
  a.best = best;
  a.new_wins = (const bool*)new_wins;
  a.keep = (const bool*)keep;
  a.flist = flist;
  a.fcount = fcount;
  a.fflag = (const bool*)fflag;
  a.valid_num = valid_num;
  a.valid_num_out = valid_num_out;
  a.trunc = trunc;
  a.tally = tally;
  a.out.flist = flist_out;
  a.out.fcount = fcount_out;
  a.out.fflag = (bool*)fflag_out;
  a.out.keep = (bool*)keep_out;
  a.st = make_store(obs_pose, init_id, M, V, translation_gap, rotation_gap);
  a.G = G;
  correspond_hits_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// What the compiler says of kernel `which` (0 nms_greedy, 1 correspond_hits):
// info = {registers per thread, local (spill + stack) bytes per thread,
// static shared bytes, threads per block, dynamic shared bytes at capacity
// G}.  Returns a cudaError_t.
extern "C" int step_kernel_info(int which, int G, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, which == 0 ? (const void*)nms_greedy_kernel : (const void*)correspond_hits_kernel);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = kThreads;
  info[4] = which == 0 ? (int)nms_smem_bytes(G) : 0;
  return (int)err;
}

// The kernels' float32 terms of _pose_differs for N pose pairs (row-major
// 4x4 each), for the bit check against PyTorch: out[n] = {baseline norm
// (norm3, also the centre escape's norm), trace, angle in degrees, the
// decision at the gaps (1 or 0)}.  Returns a cudaError_t.
extern "C" int step_pose_bits(const float* pm, const float* pr, int N, float translation_gap,
                              float rotation_gap, float* out, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  Gaps gaps;
  gaps.translation = translation_gap;
  gaps.rotation = rotation_gap;
  pose_bits_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(pm, pr, N, gaps, out);
  return (int)cudaGetLastError();
}
