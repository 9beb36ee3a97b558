// Tiled softmax attention with an exact two-sweep softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/pallas_attention_ablation.py:_attn_kernel
// (launched by tiled_attention's pl.pallas_call).  q, k, v are contiguous
// (BH, N, D) tensors, one (batch x head) slice per leading index, no mask and
// no head packing; the output is (BH, N, D) in the inputs' type.  For every
// slice it computes
//   s = (q k^T) * D^-0.5       accumulated in float32
//   m = max(s) over keys, p = exp(s - m), l = sum(p)      in float32
//   o = cast(p, v's type) v / l    accumulated in float32, stored in q's type
// as the Pallas body and the plain PyTorch twin
// (boxfusion_tpu_torch/tools/attention_ablation.py:reference_attention) do.
// Both matrix products, the scale, the ragged-edge handling and the softmax
// are in this file; nothing is left to a library.
//
// What differs from the TPU kernel, and why.  The Pallas body holds one query
// tile and the WHOLE K and V of its slice in fast memory, so the full score
// row is there at once and the softmax is one pass with no running rescale.
// K and V of one slice are 1 MiB each at N = 4096 in float32; a thread block
// here has at most 227 KB of shared memory, so they are walked in tiles of 64
// keys.  What the ablation is about is kept: the softmax is exact, with no
// running maximum and no rescaling of a partial output.  That takes two
// sweeps over the keys:
//   sweep 1: q k^T per key tile, only the row maximum m is kept;
//   sweep 2: q k^T again, p = exp(s - m) against the FINAL maximum, the row
//            sum l and the weighted sum of V rows accumulate side by side.
// The first product is done twice and nothing is ever rescaled; the online
// kernel (csrc/attention_kernel.cu) does it once and rescales its output tile
// at every key tile.  The ablation says which costs more on this card.
//
// Work split: grid (ceil(N / 64), BH), 256 threads.  Thread (ty, tx) owns
// query rows 4ty..4ty+3 and the strided columns tx + 16j of a score tile or of
// the output, so a score row lives in the 16 lanes of a half warp and its
// maximum and sum are four xor-shuffles.  Nothing is padded in device memory:
// rows past N in the last query or key tile are zeros in shared memory, their
// scores are left out of the maximum and get probability 0, and query rows
// past N are not stored.  The TPU kernel's query tile (block_q) has no
// counterpart in the result and is not an argument here.
//
// Types: float32 inputs stay float32 (FMA, never TF32); bfloat16 inputs are
// widened to float32 as they are loaded into shared memory, the probabilities
// are rounded to bfloat16 and widened again before the second product (the
// cast to v's type), and the output is rounded once.  No tensor cores, no
// cp.async or TMA: plain FMA loops from shared memory.
//
// What bounds it on this card: operations.  At BH = 12, N = 1024, D = 64 the
// function as defined does 4 BH N^2 D = 3.2 GFLOP (0.048 ms at 67 TFLOP/s of
// float32 FMA) and moves 4 arrays of 3.1 MB (0.004 ms at 3.35 TB/s); this
// kernel does the first product twice, 6 BH N^2 D.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (ops/build.py).  FMA
// contraction is left on: the contract here is a tolerance, not bit equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kLdS = kBN + 4;  // row pitch of the probability tile, in floats
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The cast of a probability to v's type, widened back for the FMA product.
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Rows [row0, row0 + 64) of one slice's (N, HD) block -> float32 shared
// memory [64][HD + 4]; rows past N become zeros.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0, int n_rows,
                                          float* __restrict__ dst) {
  constexpr int kChunks = HD / 4;
  constexpr int kLd = HD + 4;
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (long long)(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * kLd + c) = x;
  }
}

// acc[i][j] = q row (4ty + i) . k row (tx + 16j), over HD channels.
template <int HD>
__device__ __forceinline__ void score_tile(const float* __restrict__ Qs,
                                           const float* __restrict__ Ks, int ty, int tx,
                                           float (&acc)[4][4]) {
  constexpr int kLd = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * kLd + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * kLd + c]);
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
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
tiled_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int n_tok, float scale) {
  constexpr int kLd = HD + 4;     // pitch of Q, K, V tiles: 16-byte rows, no bank conflicts
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [64][kLd]; reused to stage the output
  float* Ks = Qs + kBM * kLd;   // [64][kLd]
  float* Vs = Ks + kBN * kLd;   // [64][kLd]
  float* Ps = Vs + kBN * kLd;   // [64][kLdS] probabilities of one key tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBM;
  const long long slice = (long long)blockIdx.y * n_tok * HD;
  const T* qp = q + slice;
  const T* kp = k + slice;
  const T* vp = v + slice;

  load_tile<HD>(qp, q0, n_tok, Qs);

  // sweep 1: the row maximum over all keys
  float m[4] = {kMasked, kMasked, kMasked, kMasked};
  float acc[4][4];
  for (int k0 = 0; k0 < n_tok; k0 += kBN) {
    __syncthreads();  // the previous K tile is done with (and Q is loaded)
    load_tile<HD>(kp, k0, n_tok, Ks);
    __syncthreads();
    score_tile<HD>(Qs, Ks, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j < n_tok) {
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], acc[i][j] * scale);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], d));
  }

  // sweep 2: probabilities against the final maximum, row sums, weighted V
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;

  for (int k0 = 0; k0 < n_tok; k0 += kBN) {
    __syncthreads();  // the previous tile's K, V and probabilities are done with
    load_tile<HD>(kp, k0, n_tok, Ks);
    load_tile<HD>(vp, k0, n_tok, Vs);
    __syncthreads();
    score_tile<HD>(Qs, Ks, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = (k0 + col < n_tok) ? expf(acc[i][j] * scale - m[i]) : 0.f;
        l[i] += p;  // the sum adds the unrounded float32 values
        Ps[(4 * ty + i) * kLdS + col] = round_to(p, v);
      }
    __syncthreads();

    // o += p v: rows 4ty + i, columns tx + 16c
#pragma unroll 2
    for (int j = 0; j < kBN; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * kLdS + j]);
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

  // row sums across the half warp; normalise; stage in shared memory (Q is no
  // longer needed: every thread passed the last barrier after its last read)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], d);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) Qs[(4 * ty + i) * kLd + tx + 16 * c] = o[i][c] / l[i];
  }
  __syncthreads();
  constexpr int kChunks = HD / 4;
  T* op = out + slice;
  for (int idx = tid; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    if (q0 + r < n_tok)
      store4(op + (long long)(q0 + r) * HD + c, *reinterpret_cast<const float4*>(&Qs[r * kLd + c]));
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int n_tok,
                   float scale, cudaStream_t stream) {
  constexpr int kLd = HD + 4;
  const size_t smem = sizeof(float) * (3 * kBM * kLd + kBM * kLdS);
  cudaError_t err = cudaFuncSetAttribute(tiled_attention_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kBM - 1) / kBM, BH);
  tiled_attention_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, n_tok, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int BH, int n_tok,
                     int hd, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, out, BH, n_tok, scale, stream);
    case 32: return launch<32, T>(q, k, v, out, BH, n_tok, scale, stream);
    case 64: return launch<64, T>(q, k, v, out, BH, n_tok, scale, stream);
    case 128: return launch<128, T>(q, k, v, out, BH, n_tok, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry.  q, k, v, out: device pointers to contiguous (BH, N, hd) tensors,
// 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`;
// returns the cudaError_t of the launch (0 = launched), cudaErrorInvalidValue
// for a head width or type it does not take.
extern "C" int tiled_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int BH, int N, int hd, float scale, int dtype,
                                      void* stream) {
  if (BH <= 0 || N <= 0) return (int)cudaSuccess;
  if (BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(q, k, v, out, BH, N, hd, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, out, BH, N, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
