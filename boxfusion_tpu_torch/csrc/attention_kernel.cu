// Whole-sequence multi-head attention (no mask) for Hopper (sm_90a).
//
// Replaces the TPU kernel boxfusion_tpu/ops/attention_kernel.py:_kernel
// (launched by whole_seq_attention's pl.pallas_call).  q, k, v are (B, T, D)
// with D = heads * hd, head h in columns [h*hd, (h+1)*hd); the output is
// (B, T, D) in the inputs' type.  For every (sequence, head) it computes
//   s = (q k^T) * scale        accumulated in float32
//   p = softmax(s) over keys   in float32
//   o = cast(p, v's type) v    accumulated in float32, stored in q's type
// as the Pallas body and the plain PyTorch twin
// (boxfusion_tpu_torch/ops/attention_kernel.py:whole_seq_attention_reference)
// do.  Both matrix products, the scale, the ragged-edge mask and the softmax
// are in this file; nothing is left to a library.
//
// What differs from the TPU kernel, and why.  The Pallas body keeps one whole
// padded sequence with all its heads in fast memory and walks the heads in a
// loop, one grid cell per sequence.  A block here has at most 227 KB of
// shared memory and the card has 132 SMs, so the work is cut into blocks of
// one (sequence, head) and a run of its query rows, and each block walks the
// keys in tiles of 64 with a running row maximum m and row sum l (the
// "online" softmax), so T is not bounded by shared memory: the CLIP label
// batch (T = 257) and CuTR's global blocks (T = 1024) take the same path.
// Nothing is padded in device memory: rows past T are zeros in shared memory,
// their scores are masked before the softmax, and they are not stored.
//
// One rounding differs from the twin.  With key tiles the probabilities are
// cast to v's type as exp(s - m_running), before the division by the row
// sum, where the twin casts exp(s - m) / l.  In float32 the cast is a no-op;
// in bfloat16 each probability is still rounded once, at another scale, so
// results move by bfloat16 rounding only.  The row sum l adds the unrounded
// float32 values, as the twin's softmax does.
//
// Two kernels, one per input type:
//  * attn_fma_kernel<HD>: float32 inputs, which must not go through TF32 (the
//    contract is 1e-5): FMA loops from shared memory, 256 threads, thread
//    (ty, tx) owns query rows 4ty..4ty+3 and strided columns tx + 16j (at
//    hd 72 the last column step is half full: threads tx >= 8 skip it); grid
//    (ceil(T / 64), heads, B).
//  * attn_wgmma_kernel<HD>: bfloat16 inputs, both products on wgmma, fed by
//    a ring of asynchronous copies.  See the note above it.
//
// What bounds it on this card: bytes.  At the main shape (B = 128, T = 257,
// 16 heads x 64, bfloat16) the function moves 4*B*T*D*2 = 269 MB (0.080 ms at
// 3.35 TB/s) and does 4*B*heads*T*T*hd = 34.6 GFLOP (0.035 ms at 989 TFLOP/s
// bf16).  Its predecessor (one block of 4 warps per 64 query rows,
// mma.sync.m16n8k16, synchronous 16-byte loads) took 0.316 ms there.  The
// bfloat16 design answers what held it back:
//  * loads never overlapped the products: K and V tiles now pass through a
//    ring of shared-memory slots filled by cp.async, `stages - 1` pairs
//    ahead of the one computed (5 slots at the main shape, 3 when K and V
//    stream);
//  * 20% of its blocks held one live query row (T = 257 = 4 x 64 + 1): the
//    rows are now cut into ceil(T / 64) near-equal tiles (51-52 rows at
//    T = 257), and a block of two warpgroups walks all five tiles of a
//    (sequence, head), so no block or tile exists for the 257th row;
//  * K and V were read five times from L2: where a head's K and V fit (T <=
//    320 at hd <= 64) the block loads them once and keeps them;
//  * the last key tile held one live key of 64: its 16-key chunks past T skip
//    the exp and the second product;
//  * both products ran on mma.sync: S = Q K^T and O = P V are now wgmma
//    m64nNk16 with P handed over in registers.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// 0.274 ms at the main shape, 0.98 TB/s, against 0.232 ms for
// F.scaled_dot_product_attention on the same inputs; 128 registers, 0
// spills, 112 KiB of shared memory, 2 blocks per SM.  It is not at its
// bound: each warpgroup runs its two products and its softmax one after the
// other, and 2 blocks of 8 warps per SM (the 128-register, 112 KiB budget)
// do not hide that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (ops/build.py).  FMA
// contraction is left on: the contract here is a tolerance, not bit equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kBM = 64;          // query rows per block
constexpr int kBN = 64;          // keys per tile
constexpr float kMasked = -1e30f;

// --------------------------------------------------------------- FMA kernel
constexpr int kFmaThreads = 256;
constexpr int kLdS = kBN + 4;  // row pitch of the score tile, in floats

// Rows [row0, row0 + 64) of one head's (T, HD) block -> shared memory
// [64][HD + 4]; rows past T become zeros.  16-byte loads along the channel
// axis: consecutive threads read consecutive chunks of a row.
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, long long row_stride,
                                          int row0, int n_rows, float* __restrict__ dst) {
  constexpr int kChunks = HD / 4;
  constexpr int kLd = HD + 4;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kFmaThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = raw;  // rows of HD + 4 floats stay 16-byte aligned
  }
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
attn_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int n_tok, long long q_sb, long long q_sr, long long k_sb,
                long long k_sr, long long v_sb, long long v_sr, long long o_sb, long long o_sr,
                float scale) {
  constexpr int kLd = HD + 4;    // pitch of Q, K, V tiles: 16-byte rows, no bank conflicts
  constexpr int kCols = (HD + 15) / 16;  // output columns per thread, the last one partial at hd 72
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [64][kLd]; reused to stage the output
  float* Ks = Qs + kBM * kLd;     // [64][kLd]
  float* Vs = Ks + kBN * kLd;     // [64][kLd]
  float* Ss = Vs + kBN * kLd;     // [64][kLdS] scores, then probabilities
  float* m_s = Ss + kBM * kLdS;   // [64] running row maximum
  float* l_s = m_s + kBM;         // [64] running row sum
  float* a_s = l_s + kBM;         // [64] this tile's rescale factor

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBM, head = blockIdx.y, b = blockIdx.z;
  const float* qp = q + b * q_sb + head * HD;
  const float* kp = k + b * k_sb + head * HD;
  const float* vp = v + b * v_sb + head * HD;

  load_tile<HD>(qp, q_sr, q0, n_tok, Qs);
  if (tid < kBM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;

  for (int k0 = 0; k0 < n_tok; k0 += kBN) {
    __syncthreads();  // the previous tile's K, V and probabilities are done with
    load_tile<HD>(kp, k_sr, k0, n_tok, Ks);
    load_tile<HD>(vp, v_sr, k0, n_tok, Vs);
    __syncthreads();

    // scores: rows 4ty + i, columns tx + 16j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * kLd + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * kLd + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        Ss[(4 * ty + i) * kLdS + col] = (k0 + col < n_tok) ? acc[i][j] * scale : kMasked;
      }
    __syncthreads();

    // online softmax: 4 threads per row, columns part + 4x
    {
      const int r = tid >> 2, part = tid & 3;
      float* srow = Ss + r * kLdS;
      float tile_max = kMasked;
#pragma unroll
      for (int x = 0; x < kBN / 4; ++x) tile_max = fmaxf(tile_max, srow[part + 4 * x]);
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tile_max);
      float sum = 0.f;
#pragma unroll
      for (int x = 0; x < kBN / 4; ++x) {
        const float p = expf(srow[part + 4 * x] - m_new);
        sum += p;
        srow[part + 4 * x] = p;  // v is float32: the cast to its type is a no-op
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p v: rows 4ty + i, columns tx + 16c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
    }
#pragma unroll 2
    for (int j = 0; j < kBN; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ss[(4 * ty + i) * kLdS + j]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (HD % 16 != 0 && tx + 16 * c >= HD) continue;  // only at hd 72: past the head
        const float v0 = Vs[(j + 0) * kLd + tx + 16 * c];
        const float v1 = Vs[(j + 1) * kLd + tx + 16 * c];
        const float v2 = Vs[(j + 2) * kLd + tx + 16 * c];
        const float v3 = Vs[(j + 3) * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c] = fmaf(pv[i].x, v0, o[i][c]);
          o[i][c] = fmaf(pv[i].y, v1, o[i][c]);
          o[i][c] = fmaf(pv[i].z, v2, o[i][c]);
          o[i][c] = fmaf(pv[i].w, v3, o[i][c]);
        }
      }
    }
  }

  // normalise, stage in shared memory (Q is no longer needed), store 16 bytes a thread
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l_s[4 * ty + i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (HD % 16 == 0 || tx + 16 * c < HD) Qs[(4 * ty + i) * kLd + tx + 16 * c] = o[i][c] * inv;
  }
  __syncthreads();
  constexpr int kChunks = HD / 4;
  float* op = out + b * o_sb + head * HD;
  for (int idx = tid; idx < kBM * kChunks; idx += kFmaThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    if (q0 + r < n_tok)
      *reinterpret_cast<uint4*>(op + (long long)(q0 + r) * o_sr + c) =
          *reinterpret_cast<const uint4*>(&Qs[r * kLd + c]);
  }
}

// Shared memory of one FMA block: Q, K, V tiles, the score tile, 3 row vectors.
template <int HD>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (3 * kBM * (HD + 4) + kBM * kLdS + 3 * kBM);
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, int B, int n_tok,
                       int heads, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attn_fma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kBM - 1) / kBM, heads, B);
  attn_fma_kernel<HD><<<grid, kFmaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, n_tok, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const void* q, const void* k, const void* v, void* out, int B, int n_tok,
                         int heads, int hd, const long long* st, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_fma<16>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 32: return launch_fma<32>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 64: return launch_fma<64>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 72: return launch_fma<72>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 80: return launch_fma<80>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 128: return launch_fma<128>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ----------------------------------------------------------- wgmma kernel
// bfloat16 on the warpgroup tensor-core instruction wgmma.mma_async (float32
// accumulators), fed by a ring of cp.async copies.  A block is two
// warpgroups (256 threads) and one (sequence, head); it owns a run of that
// head's query tiles and its warpgroups take them two at a time (a round),
// each its own tile.  The wrapper's plan (ops/attention_kernel.py:plan_bf16)
// cuts T into ceil(T / 64) near-equal query tiles (at T = 257: 51 or 52 rows,
// each in one 64-row wgmma tile), so no tile exists for a few tail rows.
//
// The block walks a stream of (round, key tile) pairs; key tiles are 64 keys
// and pass through `stages` slots of shared memory, filled by cp.async, one
// commit group per pair, `stages - 1` pairs ahead of the one computed; one
// barrier per pair, after which the slot of the pair before is refilled.
// When the head's key tiles all fit (`stages` >= key tiles: T = 257 at hd 64
// takes 5 slots, 112 KiB with the Q buffers) they are loaded once and every
// round reuses them (K and V leave L2 once); otherwise a block owns two or
// three query tiles and K and V stream through up to 3 slots.  Q tiles
// alternate between two buffers per warpgroup, loaded with the first pair of
// their round; a buffer also stages its tile's output for 16-byte stores.
//
// Per pair: S = Q K^T by wgmma m64n64k16 with Q's fragments in registers
// (loaded once per query tile by ldmatrix) and K from shared memory; the
// online softmax on the accumulators in registers, in base 2 with the scale
// folded into one FFMA a score; O += P V by wgmma m64nHDk16 with P's
// fragments in registers -- in the accumulator layout a warp holds rows
// 16w..16w+15, lane = 4g + t rows g and g + 8 at columns 2t, 2t + 1 of every
// 8 columns, which rounded to bfloat16 in pairs is already the A operand --
// and V from shared memory read as MN-major (the descriptor's transpose bit),
// so nothing is transposed by hand.  Shared tiles use the descriptors'
// "interleaved" layout, [HD / 8][64 rows][8]: a core matrix (8 rows x 16
// bytes) is 128 contiguous bytes, one layout for every head width (hd 80
// needs no padding), and 16-byte cp.async chunks land in it directly.  A key
// tile with keys past T masks them; its 16-key chunks wholly past T are
// skipped in the second product.
//
// Head width 72 (SigLIP's), which wgmma's 16-channel step does not divide:
// every tile is laid out 80 channels wide, [10][64][8], and its tenth chunk
// (channels 72-79) is written with zeros once, when the block starts; no copy
// writes there, since in device memory those columns are the next head's.
// S = Q K^T then runs five k-steps, the last over 8 live channels and 8 zeros;
// O += P V is m64n72k16 (its N needs only a multiple of 8); rows are copied
// as nine 16-byte chunks (copy_tile takes an odd count).  Every other head
// width is a multiple of 16 and compiles as before.
constexpr int kTile = 64;         // query rows per wgmma tile and keys per ring slot
constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kWgs = 2;           // warpgroups a block: each its own query tile, K and V shared

// channels of a shared tile: the head width rounded up to wgmma's k16 step
__host__ __device__ constexpr int padded_width(int hd) { return (hd + 15) / 16 * 16; }

// Rows [row0, row0 + 64) of one head's (T, HD) block -> channels [0, HD) of
// a shared tile [padded_width(HD) / 8][64][8], by cp.async; rows at or past
// row_end become zeros.  Two neighbouring threads copy the two halves of one
// 32-byte sector of a row; of an odd chunk count (hd 72: 9) the last chunk
// goes one thread a row.
template <int HD>
__device__ __forceinline__ void copy_tile(const __nv_bfloat16* __restrict__ src, long long row_stride,
                                          int row0, int row_end, __nv_bfloat16* dst) {
  constexpr int kChunks = HD / 8;
  constexpr int kPaired = kChunks & ~1;  // chunks copied in pairs
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kWgs * kWgThreads) {
    int r, c;
    if (kPaired == kChunks || idx < kTile * kPaired) {
      const int p = idx >> 1;
      r = p % kTile;
      c = 2 * (p / kTile) + (idx & 1);
    } else {
      r = idx - kTile * kPaired;
      c = kPaired;
    }
    const bool live = row0 + r < row_end;
    cp_async16(smem_addr(dst + (c * kTile + r) * 8),
               src + (live ? (long long)(row0 + r) * row_stride + c * 8 : 0), live);
  }
}

// One (query tile, key tile) pair for the warpgroup: scores, online softmax,
// o = o * alpha + p v.  Ks, Vs: the slot's tiles.  kPartial: only n_live < 64
// keys of the tile lie before T; they are masked, and the 16-key chunks
// wholly past T are left out of the second product.
template <int HD, bool kPartial>
__device__ __forceinline__ void pair_body(const __nv_bfloat16* Ks, const __nv_bfloat16* Vs, int n_live,
                                          uint32_t (&qf)[padded_width(HD) / 16][4], float (&oacc)[HD / 2],
                                          float (&m_run)[2], float (&l_run)[2], float scale_log2,
                                          int lane) {
  constexpr int kKc = padded_width(HD) / 16;
  const int t = lane & 3;
  const int live16 = kPartial ? (n_live + 15) >> 4 : kTile / 16;

  // S = Q K^T: K is the K-major B operand, [padded_width / 8][64 keys][8]: core
  // matrices 16 bytes apart along the keys (8 of them = 128 bytes, the stride
  // offset), 1024 bytes apart along the channels (the leading offset)
  float sacc[kTile / 2];
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc)
    WgmmaRS<kTile, 0>::mma(sacc, qf[kc], smem_desc(Ks + kc * 2 * kTile * 8, kTile * 16, 128), kc > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sacc);

  // running maximum of the raw scores (scale_log2 >= 0: for a negative
  // scale the kernel negates Q instead), masked keys left out; then
  // p = 2^(c s - c max) with c = scale * log2 e, one FFMA and one exp a score.
  // sacc[4j + e]: row g + 8 (e >> 1), key 8j + 2t + (e & 1).
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    if (kPartial && (j >> 1) >= live16) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = sacc[4 * j + e];
      if (kPartial && j * 8 + 2 * t + (e & 1) >= n_live) s = -INFINITY;
      tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s);
    }
  }
  float alpha[2], m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    m_new[r] = fmaxf(m_run[r], tile_max[r] * scale_log2);  // in units of log2; finite: a tile has a live key
    alpha[r] = ex2(m_run[r] - m_new[r]);  // 0 on the first tile
    m_run[r] = m_new[r];
  }

  // probabilities, rounded to bfloat16 in pairs: the A fragments of the
  // second product (16 keys a fragment); l keeps this thread's partial row
  // sums (the quad adds them at the end)
  uint32_t pf[kTile / 16][4];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    if (kPartial && (j >> 1) >= live16) continue;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(sacc[4 * j + e], scale_log2, -m_new[e >> 1]));
      if (kPartial && j * 8 + 2 * t + (e & 1) >= n_live) p[e] = 0.f;
    }
    sum[0] += p[0] + p[1];
    sum[1] += p[2] + p[3];
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    oacc[4 * j + 0] *= alpha[0];
    oacc[4 * j + 1] *= alpha[0];
    oacc[4 * j + 2] *= alpha[1];
    oacc[4 * j + 3] *= alpha[1];
  }

  // O += P V: V is the MN-major B operand (keys along K, channels along N):
  // core matrices 16 bytes apart along the keys (8 keys = 128 bytes, the
  // leading offset), 1024 bytes apart along the channels (the stride offset);
  // 16 keys a step
  fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if (kPartial && kk >= live16) continue;  // uniform over the block
    WgmmaRS<HD, 1>::mma(oacc, pf[kk], smem_desc(Vs + kk * 16 * 8, 128, kTile * 16), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(oacc);
}

template <int HD>
__global__ void __launch_bounds__(kWgs * kWgThreads, HD <= 80 ? 2 : 1)
attn_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int n_tok,
                  int n_qtiles, int n_groups, int stages, long long q_sb, long long q_sr, long long k_sb,
                  long long k_sr, long long v_sb, long long v_sr, long long o_sb, long long o_sr,
                  float scale_log2) {
  static_assert(HD % 8 == 0, "rows are copied in 16-byte chunks");
  constexpr int kHdP = padded_width(HD);
  constexpr int kKc = kHdP / 16;
  constexpr int kChunks = HD / 8;
  constexpr int kTileElems = kTile * kHdP;  // one [kHdP / 8][64][8] tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kWgs][tile]
  __nv_bfloat16* ring = Qbuf + 2 * kWgs * kTileElems;                 // [stages][K, V][tile]

  const int wg = threadIdx.x / kWgThreads, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  const int head = blockIdx.y, b = blockIdx.z;
  const int n_kt = (n_tok + kTile - 1) / kTile;
  // this block's query tiles [t0, t1), kWgs to a round (one per warpgroup);
  // tile i holds rows [i T / n_qtiles, (i + 1) T / n_qtiles)
  const int t0 = (int)((long long)blockIdx.x * n_qtiles / n_groups);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_qtiles / n_groups);
  const bool resident = n_kt <= stages;  // K, V loaded once; key tile j stays in slot j
  const int n_stream = (t1 - t0 + kWgs - 1) / kWgs * n_kt;  // (round, key tile) pairs
  const __nv_bfloat16* qp = q + b * q_sb + head * HD;
  const __nv_bfloat16* kp = k + b * k_sb + head * HD;
  const __nv_bfloat16* vp = v + b * v_sb + head * HD;
  auto rows_of = [&](int qt, int& q0, int& q1) {
    q0 = (int)((long long)qt * n_tok / n_qtiles);
    q1 = (int)((long long)(qt + 1) * n_tok / n_qtiles);
  };
  if constexpr (kHdP != HD) {
    // channels [HD, kHdP) of every Q, K and V tile are zeros for the block's
    // life: S = Q K^T contracts over them and no copy writes there (the first
    // pair's proxy fence and barrier make them visible to wgmma)
    constexpr int kPad = (kHdP - HD) / 8;
    for (int idx = threadIdx.x; idx < (2 * kWgs + 2 * stages) * kPad * kTile; idx += kWgs * kWgThreads) {
      const int tile = idx / (kPad * kTile), c = kChunks + (idx / kTile) % kPad, row = idx % kTile;
      *reinterpret_cast<uint4*>(Qbuf + tile * kTileElems + (c * kTile + row) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the next pair to load: its index, round, key tile, slot
  int lu = 0, lr = 0, ljt = 0, lslot = 0;
  auto load_next = [&]() {
    if (lu < n_stream) {
      if (ljt == 0) {
        for (int w = 0; w < kWgs; ++w) {
          const int qt = t0 + lr * kWgs + w;
          if (qt >= t1) break;
          int q0, q1;
          rows_of(qt, q0, q1);
          copy_tile<HD>(qp + (long long)q0 * q_sr, q_sr, 0, q1 - q0, Qbuf + ((lr & 1) * kWgs + w) * kTileElems);
        }
      }
      if (!resident || lr == 0) {
        __nv_bfloat16* Ks = ring + (resident ? ljt : lslot) * 2 * kTileElems;
        copy_tile<HD>(kp, k_sr, ljt * kTile, n_tok, Ks);
        copy_tile<HD>(vp, v_sr, ljt * kTile, n_tok, Ks + kTileElems);
      }
    }
    cp_async_commit();  // one group per pair, empty ones included: the count stays uniform
    ++lu;
    if (++lslot == stages) lslot = 0;
    if (++ljt == n_kt) ljt = 0, ++lr;
  };
  for (int p = 0; p < stages - 1; ++p) load_next();

  // softmax(c s) with c = scale log2 e; a negative c becomes -c and -Q
  const float c_log2 = fabsf(scale_log2);
  const uint32_t q_sign = scale_log2 < 0.f ? 0x80008000u : 0u;
  uint32_t qf[kKc][4];
  float oacc[HD / 2];
  float m_run[2], l_run[2];  // rows g and g + 8: running maximum (in units of log2), partial sum
  int r = 0, jt = 0, slot = 0;
  for (int s = 0; s < n_stream; ++s) {
    cp_async_wait(stages - 2);  // this thread's copies of pair s have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's have; everyone is done with pair s - 1
    load_next();      // pair s + stages - 1, into the slot of pair s - 1
    const int qt = t0 + r * kWgs + wg;
    if (qt < t1) {  // uniform over the warpgroup: in a last round with fewer tiles, it idles
      __nv_bfloat16* Qs = Qbuf + ((r & 1) * kWgs + wg) * kTileElems;
      if (jt == 0) {
        // Q's A fragments: warp w rows 16w..16w+15, ldmatrix.x4 per 16 channels
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
#pragma unroll
        for (int kc = 0; kc < kKc; ++kc) {
          ldmatrix_x4(qf[kc], smem_addr(Qs + ((2 * kc + half) * kTile + row) * 8));
#pragma unroll
          for (int i = 0; i < 4; ++i) qf[kc][i] ^= q_sign;  // -Q for a negative scale
        }
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
        m_run[0] = m_run[1] = -INFINITY;
        l_run[0] = l_run[1] = 0.f;
      }
      const __nv_bfloat16* Ks = ring + (resident ? jt : slot) * 2 * kTileElems;
      const int n_live = n_tok - jt * kTile;
      if (n_live >= kTile)
        pair_body<HD, false>(Ks, Ks + kTileElems, n_live, qf, oacc, m_run, l_run, c_log2, lane);
      else
        pair_body<HD, true>(Ks, Ks + kTileElems, n_live, qf, oacc, m_run, l_run, c_log2, lane);

      if (jt == n_kt - 1) {
        // the query tile is done: row sums over the quad, normalise; stage the
        // warp's 16 rows in its own rows of the tile's Q buffer (Q is in
        // registers; the buffer is refilled only after a later barrier, as the
        // plan keeps stages <= key tiles + 1); 16-byte stores of the rows before q1
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float l = l_run[i];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          inv[i] = 1.f / l;
        }
        const int g = lane >> 2, t = lane & 3, r_lo = warp * 16 + g;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<uint32_t*>(Qs + (j * kTile + r_lo) * 8 + 2 * t) =
              pack_bf16(oacc[4 * j + 0] * inv[0], oacc[4 * j + 1] * inv[0]);
          *reinterpret_cast<uint32_t*>(Qs + (j * kTile + r_lo + 8) * 8 + 2 * t) =
              pack_bf16(oacc[4 * j + 2] * inv[1], oacc[4 * j + 3] * inv[1]);
        }
        __syncwarp();
        int q0, q1;
        rows_of(qt, q0, q1);
        __nv_bfloat16* op = out + b * o_sb + head * HD;
        for (int idx = lane; idx < 16 * kChunks; idx += 32) {
          const int rr = idx / kChunks, c = idx % kChunks;
          const int row = q0 + warp * 16 + rr;
          if (row < q1)
            *reinterpret_cast<uint4*>(op + (long long)row * o_sr + c * 8) =
                *reinterpret_cast<const uint4*>(Qs + (c * kTile + warp * 16 + rr) * 8);
        }
      }
    }
    if (++slot == stages) slot = 0;
    if (++jt == n_kt) jt = 0, ++r;
  }
  cp_async_wait(0);
}

// Shared memory of one block: two Q tiles per warpgroup and `stages` K, V
// slots, each tile padded_width(HD) channels wide.
template <int HD>
size_t wgmma_smem_bytes(int stages) {
  return sizeof(__nv_bfloat16) * (size_t)(2 * kWgs + 2 * stages) * kTile * padded_width(HD);
}

// plan = {n_qtiles, n_groups, stages, smem_bytes}, from
// ops/attention_kernel.py:plan_bf16; refused (cudaErrorInvalidValue) unless
// query tiles hold at most 64 rows, smem_bytes is what the layout needs, and
// stages <= key tiles + 1 (the Q buffers' reuse rule).  Grid (n_groups,
// heads, B): group g owns query tiles [g n_qtiles / n_groups, (g + 1) ...).
template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int n_tok,
                         int heads, const long long* st, float scale, const int* plan,
                         cudaStream_t stream) {
  const int n_qtiles = plan[0], n_groups = plan[1], stages = plan[2];
  const int n_kt = (n_tok + kTile - 1) / kTile;
  if (n_qtiles < 1 || n_qtiles > n_tok || (n_tok + n_qtiles - 1) / n_qtiles > kTile || n_groups < 1 ||
      n_groups > n_qtiles || n_groups > 65535 || stages < 2 || stages > 5 || stages > n_kt + 1 ||
      (size_t)plan[3] != wgmma_smem_bytes<HD>(stages))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan[3]);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_groups, heads, B);
  attn_wgmma_kernel<HD><<<grid, kWgs * kWgThreads, plan[3], stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, n_tok,
      n_qtiles, n_groups, stages, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}


template <int HD>
cudaError_t info_at(int dtype, int smem_bytes, int* info) {
  if (dtype == 0) return kernel_info(attn_fma_kernel<HD>, kFmaThreads, (int)fma_smem_bytes<HD>(), info);
  if (dtype != 1) return cudaErrorInvalidValue;
  return kernel_info(attn_wgmma_kernel<HD>, kWgs * kWgThreads, smem_bytes, info);
}

}  // namespace

// C entry.  q, k, v, out: device pointers to (B, T, heads * hd) tensors whose
// channel axis is contiguous; strides = {q batch, q row, k batch, k row,
// v batch, v row, out batch, out row} in elements, every row 16-byte aligned.
// dtype: 0 = float32 (the FMA kernel; plan unused), 1 = bfloat16 (the wgmma
// kernel; plan = {n_qtiles, n_groups, stages, smem_bytes}).  Launches on
// `stream`; returns the cudaError_t of the launch (0 = launched),
// cudaErrorInvalidValue for a head width, type or plan it does not take.
extern "C" int whole_seq_attention_launch(const void* q, const void* k, const void* v, void* out,
                                          int B, int T, int heads, int hd,
                                          const long long* strides, float scale, int dtype,
                                          const int* plan, void* stream) {
  if (B <= 0 || T <= 0 || heads <= 0) return (int)cudaSuccess;
  if (B > 65535 || heads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_fma(q, k, v, out, B, T, heads, hd, strides, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return (int)launch_wgmma<16>(q, k, v, out, B, T, heads, strides, scale, plan, s);
    case 32: return (int)launch_wgmma<32>(q, k, v, out, B, T, heads, strides, scale, plan, s);
    case 64: return (int)launch_wgmma<64>(q, k, v, out, B, T, heads, strides, scale, plan, s);
    case 72: return (int)launch_wgmma<72>(q, k, v, out, B, T, heads, strides, scale, plan, s);
    case 80: return (int)launch_wgmma<80>(q, k, v, out, B, T, heads, strides, scale, plan, s);
    case 128: return (int)launch_wgmma<128>(q, k, v, out, B, T, heads, strides, scale, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the compiler and the occupancy calculator say of the kernel that a
// launch of this head width and type runs with `smem_bytes` of dynamic
// shared memory (ignored for float32, whose block is fixed): info =
// {registers per thread, local bytes per thread, dynamic shared bytes,
// resident blocks per SM}.  Returns a cudaError_t.
extern "C" int whole_seq_attention_info(int hd, int dtype, int smem_bytes, int* info) {
  switch (hd) {
    case 16: return (int)info_at<16>(dtype, smem_bytes, info);
    case 32: return (int)info_at<32>(dtype, smem_bytes, info);
    case 64: return (int)info_at<64>(dtype, smem_bytes, info);
    case 72: return (int)info_at<72>(dtype, smem_bytes, info);
    case 80: return (int)info_at<80>(dtype, smem_bytes, info);
    case 128: return (int)info_at<128>(dtype, smem_bytes, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
