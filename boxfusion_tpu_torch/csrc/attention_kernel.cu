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
// shared memory and the card has 132 SMs, so the work is cut into
// (sequence, head, 64-query tile) blocks: grid (ceil(T / 64), heads, B).
// Each block walks the keys in tiles of 64 with a running row maximum m and
// row sum l (the "online" softmax), so T is not bounded by shared memory: the
// CLIP label batch (T = 257) and CuTR's global blocks (T = 1024) take the
// same path.  Nothing is padded in device memory.  Rows past T in the last
// query or key tile are filled with zeros in shared memory, their scores are
// set to -1e30 (the Pallas body's mask value) before the softmax, and query
// rows past T are not stored; the 257th token costs one row of memory traffic
// and a tile of arithmetic (in the tensor-core kernel the warps of the last
// query tile whose 16 rows all lie past T skip theirs).
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
//    (ty, tx) owns query rows 4ty..4ty+3 and strided columns tx + 16j.
//  * attn_mma_kernel<HD>: bfloat16 inputs on the tensor cores through
//    mma.sync.m16n8k16 (float32 accumulators), 4 warps, one warp per 16
//    query rows; scores, softmax and probabilities stay in registers, V is
//    read through ldmatrix.trans.  See the note above it.
//
// What bounds it on this card: bytes.  At the main shape (B = 128, T = 257,
// 16 heads x 64, bfloat16) the function moves 4*B*T*D*2 = 269 MB (0.080 ms at
// 3.35 TB/s) and does 4*B*heads*T*T*hd = 34.6 GFLOP (0.035 ms at 989 TFLOP/s
// bf16).  A head's K and V (33 KB each) are re-read by the 5 query tiles of
// that head from L2, not from device memory.  Neither kernel uses wgmma, TMA
// or an mbarrier pipeline, and a block's tile loads, products and softmax
// are not overlapped: on an H100 (700 W) the tensor-core kernel takes 0.32 ms
// at this shape, 4x its bound and 1.4x F.scaled_dot_product_attention, and
// skipping 15% of its products moved its time by 2% -- it waits on loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (ops/build.py).  FMA
// contraction is left on: the contract here is a tolerance, not bit equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  constexpr int kCols = HD / 16;  // output columns per thread
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
    for (int c = 0; c < kCols; ++c) Qs[(4 * ty + i) * kLd + tx + 16 * c] = o[i][c] * inv;
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

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, int B, int n_tok,
                       int heads, const long long* st, float scale, cudaStream_t stream) {
  constexpr int kLd = HD + 4;
  const size_t smem = sizeof(float) * (3 * kBM * kLd + kBM * kLdS + 3 * kBM);
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
    case 80: return launch_fma<80>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 128: return launch_fma<128>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------- tensor-core kernel
// bfloat16 on mma.sync.m16n8k16 (float32 accumulators).  128 threads: warp w
// owns query rows 16w..16w+15 of the block's 64.  In a warp, lane = 4g + t
// holds, of every 16 x 8 accumulator tile, rows g and g + 8 at columns 2t and
// 2t + 1.  So a score row lives in the 4 lanes of one quad: the row maximum
// and sum are two xor-shuffles, and the probabilities, rounded to bfloat16 in
// registers, are already laid out as the A operand of the second product (two
// neighbouring 16 x 8 score tiles make one 16 x 16 A tile).  K is read as the
// "col" B operand straight from its row-major tile (for one key, two
// neighbouring channels are one 32-bit word); V needs the transposed access
// and gets it from ldmatrix.trans.  Tile pitch HD + 8 bfloat16 keeps rows
// 16-byte aligned and the fragment reads free of bank conflicts.
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Rows [row0, row0 + 64) of one head's (T, HD) block -> bfloat16 shared
// memory [64][HD + 8]; rows past T become zeros.
template <int HD>
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* __restrict__ src,
                                               long long row_stride, int row0, int n_rows,
                                               __nv_bfloat16* __restrict__ dst) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = HD + 8;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = raw;
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int n_tok,
                long long q_sb, long long q_sr, long long k_sb, long long k_sr, long long v_sb,
                long long v_sr, long long o_sb, long long o_sr, float scale) {
  constexpr int kLd = HD + 8;
  constexpr int kKc = HD / 16;  // 16-channel chunks of the first product
  constexpr int kNt = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kLd]; output staging
  __nv_bfloat16* Ks = Qs + kBM * kLd;
  __nv_bfloat16* Vs = Ks + kBN * kLd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBM, head = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qp = q + b * q_sb + head * HD;
  const __nv_bfloat16* kp = k + b * k_sb + head * HD;
  const __nv_bfloat16* vp = v + b * v_sb + head * HD;

  load_tile_bf16<HD>(qp, q_sr, q0, n_tok, Qs);
  __syncthreads();
  uint32_t qf[kKc][4];
  {
    const __nv_bfloat16* row_lo = Qs + (warp * 16 + g) * kLd + 2 * t;
    const __nv_bfloat16* row_hi = row_lo + 8 * kLd;
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc) {
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(row_lo + kc * 16);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(row_hi + kc * 16);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(row_lo + kc * 16 + 8);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(row_hi + kc * 16 + 8);
    }
  }

  float oacc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // In the last query tile a warp whose 16 rows all lie past T has nothing to
  // compute (T = 257: three of the four warps).
  const bool warp_live = q0 + warp * 16 < n_tok;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_tok; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K and V
    load_tile_bf16<HD>(kp, k_sr, k0, n_tok, Ks);
    load_tile_bf16<HD>(vp, v_sr, k0, n_tok, Vs);
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; the barriers above are still reached

    // scores of 16 query rows x 64 keys
    float sacc[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKc; ++kc)
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * kLd + kc * 16 + 2 * t;
        mma_bf16(sacc[n], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // scale, mask the ragged edge, running maximum
    float tile_max[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float s = (col < n_tok) ? sacc[n][e] * scale : kMasked;
        sacc[n][e] = s;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s);
      }
    float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      m_new[r] = fmaxf(m_run[r], tile_max[r]);
      alpha[r] = __expf(m_run[r] - m_new[r]);  // 0 on the first tile
      m_run[r] = m_new[r];
    }

    // probabilities, cast to bfloat16 in the A-operand layout of the second product
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const float p0 = __expf(sacc[n][0] - m_new[0]);
      const float p1 = __expf(sacc[n][1] - m_new[0]);
      const float p2 = __expf(sacc[n][2] - m_new[1]);
      const float p3 = __expf(sacc[n][3] - m_new[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // o += p v: per 16 keys, two 8-column tiles of V per ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kNt; n += 2) {
        const __nv_bfloat16* vr = Vs + (kk * 16 + (lane & 15)) * kLd + (n + (lane >> 4)) * 8;
        const uint32_t addr = (uint32_t)__cvta_generic_to_shared(vr);
        uint32_t b0, b1, b2, b3;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                     : "r"(addr));
        mma_bf16(oacc[n], pf[kk], b0, b1);
        mma_bf16(oacc[n + 1], pf[kk], b2, b3);
      }
  }

  if (!warp_live) return;  // no barrier follows
  // normalise; stage this warp's 16 rows in its own rows of Qs; 16-byte stores
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  __nv_bfloat16* stage = Qs + warp * 16 * kLd;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kLd + n * 8 + 2 * t) =
        pack_bf16(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + n * 8 + 2 * t) =
        pack_bf16(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* op = out + b * o_sb + head * HD;
  for (int idx = lane; idx < 16 * (HD / 8); idx += 32) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < n_tok)
      *reinterpret_cast<uint4*>(op + (long long)row * o_sr + c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + c);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int n_tok,
                       int heads, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 3 * kBM * (HD + 8);
  cudaError_t err = cudaFuncSetAttribute(attn_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kBM - 1) / kBM, heads, B);
  attn_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, n_tok, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* out, int B, int n_tok,
                         int heads, int hd, const long long* st, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_mma<16>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 32: return launch_mma<32>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 64: return launch_mma<64>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 80: return launch_mma<80>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    case 128: return launch_mma<128>(q, k, v, out, B, n_tok, heads, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry.  q, k, v, out: device pointers to (B, T, heads * hd) tensors whose
// channel axis is contiguous; strides = {q batch, q row, k batch, k row,
// v batch, v row, out batch, out row} in elements, every row 16-byte aligned.
// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core kernel).
// Launches on `stream`; returns the cudaError_t of the launch (0 = launched),
// cudaErrorInvalidValue for a head width or type it does not take.
extern "C" int whole_seq_attention_launch(const void* q, const void* k, const void* v, void* out,
                                          int B, int T, int heads, int hd,
                                          const long long* strides, float scale, int dtype,
                                          void* stream) {
  if (B <= 0 || T <= 0 || heads <= 0) return (int)cudaSuccess;
  if (B > 65535 || heads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_fma(q, k, v, out, B, T, heads, hd, strides, scale, s);
  if (dtype == 1) return (int)dispatch_mma(q, k, v, out, B, T, heads, hd, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
