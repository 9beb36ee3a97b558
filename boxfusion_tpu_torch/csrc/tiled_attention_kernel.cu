// Tiled softmax attention over (BH, N, D) slices for Hopper (sm_90a), in one
// online sweep over the keys.
//
// Replaces the TPU kernel tools/pallas_attention_ablation.py:_attn_kernel
// (launched by tiled_attention's pl.pallas_call).  q, k, v are contiguous
// (BH, N, D) tensors, one (batch x head) slice per leading index, no mask and
// no head packing; the output is (BH, N, D) in the inputs' type.  For every
// slice it computes the Pallas body's function
//   s = (q k^T) * scale        accumulated in float32
//   p = softmax(s) over keys   in float32
//   o = cast(p, v's type) v    accumulated in float32, stored in q's type
// as the plain PyTorch twin does
// (boxfusion_tpu_torch/tools/attention_ablation.py:reference_attention).  Both
// matrix products, the scale, the ragged edge and the softmax are in this
// file; nothing is left to a library.
//
// What differs from the TPU kernel, and why.  The Pallas body holds one query
// tile and the WHOLE K and V of its slice in fast memory, so it takes the
// softmax against the row's final maximum in one pass.  K and V of one slice
// are 1 MiB each at N = 4096 in float32; a block here has at most 227 KB of
// shared memory, so the keys are walked in tiles of 64 with a running row
// maximum m and row sum l, and the output accumulator is rescaled when m
// moves (the online softmax), in base 2 with the scale folded in.  That is
// the same function: the port's first kernel for it kept the Pallas body's
// exact form with two sweeps over the keys -- one for the maximum, one for
// the probabilities, so q k^T twice -- and its results agreed with the online
// form's to 5e-7 (float32) and 2e-3 (bfloat16) at the ablation's shapes, while
// it ran 1.3-1.6x slower in float32.  One rounding moves in bfloat16: p is cast
// to v's type as 2^(c s - c m_running) before the division by l, where the
// twin casts exp(s - m) / l; each probability is still rounded once.
//
// Two kernels, one per input type.  The bfloat16 one takes its consumer count
// and ring stages from boxfusion_tpu_torch/tools/attention_ablation.py:plan_tiled;
// layout_of below works out the rest of a launch and refuses a plan the
// kernel does not take:
//
//  * tiled_wgmma_kernel<HD, kC>, bfloat16.  One block is kC consumer
//    warpgroups (kC = 2 or 3), each owning a 64-row query tile, and one
//    producer warpgroup.  The producer copies Q once and then every K and V
//    tile of the slice (128 keys; 64 with three consumers, whose 160
//    registers a thread hold no more) into a ring of `stages` shared-memory
//    slots by cp.async, and signals each slot's "full" mbarrier with
//    cp.async.mbarrier.arrive.noinc; the consumers release a slot on its
//    "empty" mbarrier.  setmaxnreg hands the producer's registers to the
//    consumers.  A consumer keeps Q's A fragments in registers and, per key
//    tile j: issues S_{j+1} = Q K_{j+1}^T (wgmma m64nNk16, K from shared
//    memory) and O += P_j V_j (wgmma m64nHDk16, P_j's bf16 pairs in
//    registers as the A operand, V through the descriptor's transpose bit);
//    waits for S_{j+1} alone (wgmma.wait_group 1) and runs its online softmax
//    in S's registers while the tensor cores still work on P_j V_j; then
//    waits for that, releases slot j, packs P_{j+1} and rescales O.  Named
//    barriers make the consumers take turns at issuing their products, so
//    one's softmax runs under another's products.  The last
//    key tile masks its keys past N before the exp.  The epilogue divides by
//    l, rounds to bf16 once, stages the tile in its Q buffer (Q is in
//    registers) and stores 16-byte rows; no row past N is stored.  Shared
//    tiles use the descriptors' no-swizzle interleaved layout [HD / 8][rows][8]
//    (hopper_common.cuh).
//  * tiled_fma_kernel<HD>, float32, which must not go through TF32 (its bound
//    is 2e-4; TF32 keeps about three decimal digits): 128 threads own 64
//    query rows; thread (ty, tx) holds the 8 x 4 scores of rows ty + 8i and
//    keys tx + 16j of a key tile and the 8 x HD/16 outputs of rows ty + 8i
//    and columns tx HD/16 ...; a row's maximum is four xor-shuffles over its
//    half warp.  Q is scaled by scale log2 e once, as it is loaded.  K and V
//    tiles are double-buffered by cp.async, so tile j + 1 loads while tile j
//    is used, with one barrier per tile.  A half warp's probability rows are
//    its own, so they pass through shared memory with __syncwarp only.
//
// What bounds it on this card: operations.  At BH = 12, D = 64 the function
// does 4 BH N^2 D operations: 3.2 GFLOP at N = 1024 (0.048 ms at 67 TFLOP/s
// of float32 FMA; 0.0033 ms at 989 TFLOP/s of bf16 on the tensor cores) and
// 51.5 GFLOP at N = 4096 (0.769 ms float32, 0.052 ms bf16); it moves 4 arrays
// of (BH, N, D), 0.0075 ms at N = 4096 in bf16 at 3.35 TB/s.  In bf16 at
// D = 64 the exps weigh as much as the products: 16 MUFU results per clock
// and SM take as long for the N^2 exps as the tensor cores take for the
// 4 N^2 D operations.  PERF.md keeps the readings and what holds each back.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (ops/build.py).  FMA
// contraction is left on: the contract here is a tolerance, not bit equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kTile = 64;        // query rows per tile; keys per float32 key tile
// keys per bfloat16 key tile (the N of S's wgmma): 128 with two consumers,
// 64 with three, whose 160 registers a thread would not hold S of 128 keys
__host__ __device__ constexpr int keys_of(int consumers) { return consumers == 3 ? 64 : 128; }
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kMaxStages = 4;    // ring slots of the bf16 kernel
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------- float32 kernel
constexpr int kFmaThreads = 128;
constexpr int kLdP = kTile + 4;  // row pitch of the probability tile, in floats

template <int HD>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * ((size_t)5 * kTile * (HD + 4) + (size_t)kTile * kLdP);  // Q, 2 x (K, V), P
}

// Rows [row0, row0 + 64) of one slice's (N, HD) block -> shared [64][HD + 4]
// by cp.async, 16 bytes a copy; rows past N become zeros.
template <int HD>
__device__ __forceinline__ void copy_tile_f32(const float* __restrict__ src, int row0, int n_rows,
                                              float* dst) {
  constexpr int kChunks = HD / 4;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kFmaThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool live = row0 + r < n_rows;
    cp_async16(smem_addr(dst + r * (HD + 4) + c), src + (live ? (long long)(row0 + r) * HD + c : 0), live);
  }
}

// n consecutive floats of shared memory, in the widest loads they allow
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x, x[i + 1] = f.y, x[i + 2] = f.z, x[i + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads, 2)
tiled_fma_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ out, int n_tok, float c_log2) {
  constexpr int kLd = HD + 4;     // 16-byte rows; neighbouring rows 4 banks apart
  constexpr int kCw = HD / 16;    // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [64][kLd], scaled; reused to stage the output
  float* KV = Qs + kTile * kLd;       // [2][K, V][64][kLd]
  float* Ps = KV + 4 * kTile * kLd;   // [64][kLdP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const long long slice = (long long)blockIdx.y * n_tok * HD;
  const float* qp = q + slice;
  const float* kp = k + slice;
  const float* vp = v + slice;
  const int n_kt = (n_tok + kTile - 1) / kTile;

  copy_tile_f32<HD>(kp, 0, n_tok, KV);
  copy_tile_f32<HD>(vp, 0, n_tok, KV + kTile * kLd);
  cp_async_commit();
  // Q, scaled by c = scale log2 e: scores come out in units of log2
  for (int idx = tid; idx < kTile * HD / 4; idx += kFmaThreads) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n_tok) x = *reinterpret_cast<const float4*>(qp + (long long)(q0 + r) * HD + c);
    x.x *= c_log2, x.y *= c_log2, x.z *= c_log2, x.w *= c_log2;
    *reinterpret_cast<float4*>(Qs + r * kLd + c) = x;
  }

  float m_run[8], l_run[8], o[8][kCw];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCw; ++c) o[i][c] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait(0);
    __syncthreads();  // tile j has landed for everyone; everyone is done with tile j - 1 and its P
    if (j + 1 < n_kt) {
      float* nxt = KV + ((j + 1) & 1) * 2 * kTile * kLd;
      copy_tile_f32<HD>(kp, (j + 1) * kTile, n_tok, nxt);
      copy_tile_f32<HD>(vp, (j + 1) * kTile, n_tok, nxt + kTile * kLd);
    }
    cp_async_commit();
    const float* Ks = KV + (j & 1) * 2 * kTile * kLd;
    const float* Vs = Ks + kTile * kLd;

    // scores of rows ty + 8i, keys tx + 16jj
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < HD; c += 4) {
      float4 qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 8 * i) * kLd + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * jj) * kLd + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }
    const int n_live = n_tok - j * kTile;
    if (n_live < kTile) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (tx + 16 * jj >= n_live) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][jj] = -INFINITY;
        }
    }

    // online softmax: the row maximum over the half warp; p = 2^(s - m)
    float alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_new = fmaxf(m_run[i], mx);  // finite: the tile has a live key
      alpha[i] = ex2(m_run[i] - m_new);         // 0 on the first tile
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ex2(s[i][jj] - m_new);
        sum += p;
        Ps[(ty + 8 * i) * kLdP + tx + 16 * jj] = p;  // v is float32: the cast is a no-op
      }
      l_run[i] = l_run[i] * alpha[i] + sum;  // this thread's part; the half warp adds them at the end
#pragma unroll
      for (int c = 0; c < kCw; ++c) o[i][c] *= alpha[i];
    }
    __syncwarp();  // the half warp's probability rows are written

    // o += p v: rows ty + 8i, columns tx kCw ... tx kCw + kCw - 1
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * kLdP + kk);
      float vv[4][kCw];
#pragma unroll
      for (int e = 0; e < 4; ++e) load_row<kCw>(Vs + (kk + e) * kLd + tx * kCw, vv[e]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kCw; ++c) {
          o[i][c] = fmaf(pv[i].x, vv[0][c], o[i][c]);
          o[i][c] = fmaf(pv[i].y, vv[1][c], o[i][c]);
          o[i][c] = fmaf(pv[i].z, vv[2][c], o[i][c]);
          o[i][c] = fmaf(pv[i].w, vv[3][c], o[i][c]);
        }
    }
  }

  // row sums over the half warp; normalise; stage in Qs; 16-byte stores
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], d);
  }
  __syncthreads();  // every thread is done reading Qs
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int c = 0; c < kCw; ++c) Qs[(ty + 8 * i) * kLd + tx * kCw + c] = o[i][c] * inv;
  }
  __syncthreads();
  float* op = out + slice;
  for (int idx = tid; idx < kTile * HD / 4; idx += kFmaThreads) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    if (q0 + r < n_tok)
      *reinterpret_cast<float4*>(op + (long long)(q0 + r) * HD + c) =
          *reinterpret_cast<const float4*>(Qs + r * kLd + c);
  }
  cp_async_wait(0);
}

// ---------------------------------------------------------- bfloat16 kernel
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives on `bar` when this thread's cp.async copies issued so far have
// landed; counts as one of the barrier's expected arrivals (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wgmma_wait_1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

template <int HD>
constexpr size_t wgmma_smem_bytes(int consumers, int stages) {
  return sizeof(__nv_bfloat16) * (size_t)(consumers * kTile + 2 * stages * keys_of(consumers)) * HD;  // Q, ring of (K, V)
}

// Rows [row0, row0 + R) of one slice's (N, HD) block -> a shared tile
// [HD / 8][R][8] by cp.async, copied by the 128 threads of one warpgroup
// (pt: the thread's index in it); rows past N become zeros.  Two neighbouring
// threads copy the two halves of one 32-byte sector of a row.
template <int HD, int R>
__device__ __forceinline__ void copy_tile_bf16(const __nv_bfloat16* __restrict__ src, int row0, int n_rows,
                                               __nv_bfloat16* dst, int pt) {
  constexpr int kChunks = HD / 8;
  for (int idx = pt; idx < R * kChunks; idx += kWgThreads) {
    const int p = idx >> 1, r = p % R, c = 2 * (p / R) + (idx & 1);
    const bool live = row0 + r < n_rows;
    cp_async16(smem_addr(dst + (c * R + r) * 8), src + (live ? (long long)(row0 + r) * HD + c * 8 : 0),
               live);
  }
}

// S = Q K^T for one key tile, issued (not waited for).  K is the K-major B
// operand [HD / 8][128 keys][8]: core matrices 128 bytes apart along the keys
// (the stride offset), 2048 bytes apart along the channels (the leading offset).
template <int HD, int kN>
__device__ __forceinline__ void issue_scores(float (&sacc)[kN / 2], const uint32_t (&qf)[HD / 16][4],
                                             const __nv_bfloat16* Ks) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    WgmmaRS<kN, 0>::mma(sacc, qf[kc], smem_desc(Ks + kc * 2 * kN * 8, kN * 16, 128), kc > 0);
}

// O += P V for one key tile, issued.  V is the MN-major B operand (keys along
// K, channels along N): core matrices 128 bytes apart along the keys (the
// leading offset), 2048 bytes apart along the channels (the stride offset).
template <int HD, int kN>
__device__ __forceinline__ void issue_pv(float (&oacc)[HD / 2], const uint32_t (&pf)[kN / 16][4],
                                         const __nv_bfloat16* Vs) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
    WgmmaRS<HD, 1>::mma(oacc, pf[kk], smem_desc(Vs + kk * 16 * 8, 128, kN * 16), 1);
}

// The online softmax of one score tile in wgmma's accumulator layout
// (sacc[4j + e]: row g + 8 (e >> 1), key 8j + 2t + (e & 1)), in base 2 with
// c = scale log2 e > 0 folded into one FFMA a score: the running maximum m of
// c s (masked keys left out when kMask), alpha = 2^(m_old - m_new), and
// p = 2^(c s - m_new) in place of the scores (0 for a masked key); l takes
// this thread's part of the row sum.  Only the scores' registers are written,
// so it can run while P V of the tile before is in flight.
template <int kN, bool kMask>
__device__ __forceinline__ void online_softmax(float (&sacc)[kN / 2], int n_live, float c, float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2], int t) {
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool dead = kMask && j * 8 + 2 * t + (e & 1) >= n_live;
      tile_max[e >> 1] = fmaxf(tile_max[e >> 1], dead ? -INFINITY : sacc[4 * j + e]);
    }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    m_new[r] = fmaxf(m_run[r], tile_max[r] * c);  // finite: the tile has a live key
    alpha[r] = ex2(m_run[r] - m_new[r]);          // 0 on the first tile
    m_run[r] = m_new[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(sacc[4 * j + e], c, -m_new[e >> 1]));
      if (kMask && j * 8 + 2 * t + (e & 1) >= n_live) p = 0.f;
      sum[e >> 1] += p;
      sacc[4 * j + e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
}

// p rounded to bf16 in pairs: in the accumulator layout this is already the
// A operand of P V, 16 keys a fragment.
template <int kN>
__device__ __forceinline__ void pack_p(const float (&sacc)[kN / 2], uint32_t (&pf)[kN / 16][4]) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(sacc[4 * j + 0], sacc[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
  }
}

// Named barriers 1 .. kC order the consumers' turns at the tensor cores:
// consumer w waits on barrier 1 + w for the previous consumer's arrival
// before it issues its products, and arrives on the next one's barrier
// after, so one consumer's softmax runs while another's products do.
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ void turn_begin(int wg) { bar_sync(1 + wg); }

template <int kC>
__device__ __forceinline__ void turn_end(int wg) {
  bar_arrive(1 + (wg + 1) % kC);
}

template <int HD, int kC>
struct Consumer {
  static constexpr int kN = keys_of(kC);
  uint32_t qf[HD / 16][4];      // Q's A fragments, loaded once
  float oacc[HD / 2];           // O, float32
  float sacc[kN / 2];           // S of the key tile in flight
  uint32_t pf[kN / 16][4];      // P of the key tile whose P V is next, bf16 pairs
  float m_run[2], l_run[2];     // rows g and g + 8: running maximum (units of log2), partial sum

  // Key tile j: S_{j+1} and P_j V_j in flight together, the softmax of
  // S_{j+1} under P_j V_j, then O rescaled and slot j released.
  template <bool kMask>
  __device__ __forceinline__ void step(int j, int n_tok, int stages, float c, int t, int wg, __nv_bfloat16* ring,
                                       uint64_t* full, uint64_t* empty) {
    constexpr int kSlot = kN * HD;  // one K or V tile
    const int s1 = (j + 1) % stages, s0 = j % stages;
    mbar_wait(&full[s1], ((j + 1) / stages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the copies, visible to wgmma
    turn_begin(wg);
    fence_regs(sacc);
    fence_regs(oacc);
    wgmma_fence();
    issue_scores<HD, kN>(sacc, qf, ring + s1 * 2 * kSlot);
    wgmma_commit();
    issue_pv<HD, kN>(oacc, pf, ring + s0 * 2 * kSlot + kSlot);
    wgmma_commit();
    turn_end<kC>(wg);
    wgmma_wait_1();  // S_{j+1} is done; P_j V_j may still run
    fence_regs(sacc);
    float alpha[2];
    online_softmax<kN, kMask>(sacc, n_tok - (j + 1) * kN, c, m_run, l_run, alpha, t);
    wgmma_wait_all();
    fence_regs(oacc);
    fence_regs(sacc);  // P_{j+1} is packed into P_j's registers only after the wait
    mbar_arrive(&empty[s0]);
    pack_p<kN>(sacc, pf);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      oacc[4 * i + 0] *= alpha[0];
      oacc[4 * i + 1] *= alpha[0];
      oacc[4 * i + 2] *= alpha[1];
      oacc[4 * i + 3] *= alpha[1];
    }
  }
};

template <int HD, int kC>
__global__ void __launch_bounds__((kC + 1) * kWgThreads, 1)
tiled_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int n_tok,
                   int stages, float scale_log2) {
  constexpr int kTileElems = kTile * HD;  // one Q tile
  constexpr int kN = keys_of(kC);
  constexpr int kSlot = kN * HD;          // one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * kMaxStages + 1];
  __nv_bfloat16* Qbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kC][tile]
  __nv_bfloat16* ring = Qbuf + kC * kTileElems;                       // [stages][K, V][tile]
  uint64_t* full = bars;                 // [stages]: the producer's 128 threads arrive
  uint64_t* empty = bars + kMaxStages;   // [stages]: the consumers' threads arrive
  uint64_t* q_full = bars + 2 * kMaxStages;

  const int wg = threadIdx.x / kWgThreads;
  const int q0 = blockIdx.x * kC * kTile;
  const long long slice = (long long)blockIdx.y * n_tok * HD;
  const int n_kt = (n_tok + kN - 1) / kN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kWgThreads);
      mbar_init(&empty[s], kC * kWgThreads);
    }
    mbar_init(q_full, kWgThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kC) {
    // producer: Q once, then K and V tile j into slot j % stages when the
    // consumers have released the slot's previous tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kC == 3 ? 32 : 40));
    const int pt = threadIdx.x - kC * kWgThreads;
    for (int w = 0; w < kC; ++w) copy_tile_bf16<HD, kTile>(q + slice, q0 + w * kTile, n_tok, Qbuf + w * kTileElems, pt);
    cp_async_arrive(q_full);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % stages;
      mbar_wait(&empty[s], ((j / stages) & 1) ^ 1);  // passes at once on the first round
      __nv_bfloat16* Ks = ring + s * 2 * kSlot;
      copy_tile_bf16<HD, kN>(k + slice, j * kN, n_tok, Ks, pt);
      copy_tile_bf16<HD, kN>(v + slice, j * kN, n_tok, Ks + kSlot, pt);
      cp_async_arrive(&full[s]);
    }
    cp_async_wait(0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kC == 2 ? 232 : 160));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31, t = lane & 3;
    const float c = scale_log2;  // softmax(c s) in base 2; c > 0 (the C entry refuses any other scale)
    Consumer<HD, kC> st;
    __nv_bfloat16* Qs = Qbuf + wg * kTileElems;
    mbar_wait(q_full, 0);
    {
      // Q's A fragments: warp w rows 16w..16w+15, ldmatrix.x4 per 16 channels
      const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) ldmatrix_x4(st.qf[kc], smem_addr(Qs + ((2 * kc + half) * kTile + row) * 8));
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) st.oacc[i] = 0.f;
    st.m_run[0] = st.m_run[1] = -INFINITY;
    st.l_run[0] = st.l_run[1] = 0.f;

    // key tile 0: S_0 alone, then its softmax; the first consumer takes the first turn
    if (wg == kC - 1) bar_arrive(1);
    mbar_wait(&full[0], 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    turn_begin(wg);
    fence_regs(st.sacc);
    wgmma_fence();
    issue_scores<HD, kN>(st.sacc, st.qf, ring);
    wgmma_commit();
    turn_end<kC>(wg);
    wgmma_wait_all();
    fence_regs(st.sacc);
    float alpha[2];  // unused: O is zero
    if (n_kt == 1)
      online_softmax<kN, true>(st.sacc, n_tok, c, st.m_run, st.l_run, alpha, t);
    else
      online_softmax<kN, false>(st.sacc, n_tok, c, st.m_run, st.l_run, alpha, t);
    pack_p<kN>(st.sacc, st.pf);

    // key tiles 1 .. n_kt - 1: the last one, which may hold keys past N, masks them
    int j = 0;
    for (; j < n_kt - 2; ++j) st.template step<false>(j, n_tok, stages, c, t, wg, ring, full, empty);
    if (j == n_kt - 2) st.template step<true>(j++, n_tok, stages, c, t, wg, ring, full, empty);

    // the last P V
    turn_begin(wg);
    fence_regs(st.oacc);
    wgmma_fence();
    issue_pv<HD, kN>(st.oacc, st.pf, ring + (j % stages) * 2 * kSlot + kSlot);
    wgmma_commit();
    turn_end<kC>(wg);
    if (wg == 0) bar_sync(1);  // the last consumer's last arrival: no barrier is left half-way
    wgmma_wait_all();
    fence_regs(st.oacc);

    // row sums over the quad; normalise; stage the warp's 16 rows in its own
    // rows of the Q buffer (Q is in registers, and only this warp read those
    // rows); 16-byte stores of the rows before N
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = st.l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[i] = 1.f / l;
    }
    const int g = lane >> 2, r_lo = warp * 16 + g;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(Qs + (jj * kTile + r_lo) * 8 + 2 * t) =
          pack_bf16(st.oacc[4 * jj + 0] * inv[0], st.oacc[4 * jj + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(Qs + (jj * kTile + r_lo + 8) * 8 + 2 * t) =
          pack_bf16(st.oacc[4 * jj + 2] * inv[1], st.oacc[4 * jj + 3] * inv[1]);
    }
    __syncwarp();
    constexpr int kChunks = HD / 8;
    __nv_bfloat16* op = out + slice;
    const int row0 = q0 + wg * kTile + warp * 16;
    for (int idx = lane; idx < 16 * kChunks; idx += 32) {
      const int rr = idx / kChunks, cc = idx % kChunks;
      if (row0 + rr < n_tok)
        *reinterpret_cast<uint4*>(op + (long long)(row0 + rr) * HD + cc * 8) =
            *reinterpret_cast<const uint4*>(Qs + (cc * kTile + warp * 16 + rr) * 8);
    }
  }
}

// ------------------------------------------------------------------ host
// The launch that a head width, type and plan give: query rows a block,
// threads a block, K, V buffers, dynamic shared bytes; false for a plan the
// kernel does not take.  float32 takes no plan (consumers = stages = 0): 64
// rows, one warpgroup, two buffers.  bfloat16 takes plan_tiled's
// (boxfusion_tpu_torch/tools/attention_ablation.py): consumers = 2, or 3 at
// HD <= 64 (at 160 registers a thread three consumers would not hold O of
// 128 channels), beside the producer; 2 <= stages <= kMaxStages.
struct Layout {
  int rows, threads, stages;
  size_t smem;
};

template <int HD>
bool layout_of(int dtype, int consumers, int stages, Layout& lay) {
  if (dtype == 0) {
    lay = {kTile, kFmaThreads, 2, fma_smem_bytes<HD>()};
    return consumers == 0 && stages == 0;
  }
  lay = {consumers * kTile, (consumers + 1) * kWgThreads, stages, wgmma_smem_bytes<HD>(consumers, stages)};
  return dtype == 1 && (consumers == 2 || (consumers == 3 && HD <= 64)) && stages >= 2 && stages <= kMaxStages;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int n_tok, float scale,
                   int dtype, int consumers, int stages, cudaStream_t stream) {
  Layout lay;
  if (!(scale > 0.f) || !layout_of<HD>(dtype, consumers, stages, lay)) return cudaErrorInvalidValue;
  const dim3 grid((n_tok + lay.rows - 1) / lay.rows, BH);
  auto go = [&](auto kernel, auto... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, lay.threads, lay.smem, stream>>>(args...);
    return cudaGetLastError();
  };
  if (dtype == 0)
    return go(tiled_fma_kernel<HD>, (const float*)q, (const float*)k, (const float*)v, (float*)out, n_tok,
              scale * kLog2e);
  const auto *qb = (const __nv_bfloat16*)q, *kb = (const __nv_bfloat16*)k, *vb = (const __nv_bfloat16*)v;
  if constexpr (HD <= 64)
    if (consumers == 3) return go(tiled_wgmma_kernel<HD, 3>, qb, kb, vb, (__nv_bfloat16*)out, n_tok, stages,
                                  scale * kLog2e);
  return go(tiled_wgmma_kernel<HD, 2>, qb, kb, vb, (__nv_bfloat16*)out, n_tok, stages, scale * kLog2e);
}

template <int HD>
cudaError_t info_at(int dtype, int consumers, int stages, int* info) {
  Layout lay;
  if (!layout_of<HD>(dtype, consumers, stages, lay)) return cudaErrorInvalidValue;
  info[4] = lay.rows;
  info[5] = lay.threads / kWgThreads;
  info[6] = lay.stages;
  if (dtype == 0) return kernel_info(tiled_fma_kernel<HD>, lay.threads, (int)lay.smem, info);
  if constexpr (HD <= 64)
    if (consumers == 3) return kernel_info(tiled_wgmma_kernel<HD, 3>, lay.threads, (int)lay.smem, info);
  return kernel_info(tiled_wgmma_kernel<HD, 2>, lay.threads, (int)lay.smem, info);
}

}  // namespace

// C entry.  q, k, v, out: device pointers to contiguous (BH, N, hd) tensors,
// 16-byte aligned; scale > 0 (the wrapper passes hd^-0.5).  dtype: 0 =
// float32, 1 = bfloat16; consumers, stages: see layout_of.  Launches on
// `stream`; returns the cudaError_t of the launch (0 = launched),
// cudaErrorInvalidValue for a scale, head width, type or plan it does not take.
extern "C" int tiled_attention_launch(const void* q, const void* k, const void* v, void* out, int BH, int N,
                                      int hd, float scale, int dtype, int consumers, int stages, void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaSuccess;
  if (BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, out, BH, N, scale, dtype, consumers, stages, s);
    case 32: return (int)launch<32>(q, k, v, out, BH, N, scale, dtype, consumers, stages, s);
    case 64: return (int)launch<64>(q, k, v, out, BH, N, scale, dtype, consumers, stages, s);
    case 128: return (int)launch<128>(q, k, v, out, BH, N, scale, dtype, consumers, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the compiler, the occupancy calculator and layout_of say of the kernel
// that a launch of this head width, type and plan runs: info = {registers per
// thread (at launch; the bf16 kernel's warpgroups then move them with
// setmaxnreg), local bytes per thread, dynamic shared bytes, resident blocks
// per SM, query rows a block, warpgroups a block, K and V buffers}.  Returns a
// cudaError_t.
extern "C" int tiled_attention_info(int hd, int dtype, int consumers, int stages, int* info) {
  switch (hd) {
    case 16: return (int)info_at<16>(dtype, consumers, stages, info);
    case 32: return (int)info_at<32>(dtype, consumers, stages, info);
    case 64: return (int)info_at<64>(dtype, consumers, stages, info);
    case 128: return (int)info_at<128>(dtype, consumers, stages, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
