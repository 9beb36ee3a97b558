// The image towers' residual add and LayerNorm in one launch, bfloat16 in
// and out, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on a TPU, XLA fuses the add, the casts and the
// norm of each tower block (boxfusion_tpu/models/clip/model.py) into the
// neighbouring ops.  In eager PyTorch the same block step is four
// launches (models/cutr/layers.py:LayerNorm and the add before it):
//
//   s = x + d              bf16 add                      reads 4 B, writes 2 B
//   s.float()              cast                          reads 2 B, writes 4 B
//   F.layer_norm(float32)                                reads 4 B, writes 4 B
//   .to(bfloat16)          cast                          reads 4 B, writes 2 B
//
// 26 bytes an element, where one pass needs 8: read x and d, write s and y.
//
//   add_layer_norm_kernel<VPL, kResid>:
//     s = bf16(float(x) + float(d))             (kResid; else s is x)
//     y = bf16((s - mean(s)) * rstd * weight + bias),
//         rstd = rsqrt(var(s) + eps), float32 statistics, biased variance
//
// s rounds once, as PyTorch's bfloat16 add does, so it is bit-equal to
// `x + d`; the statistics are those of s as stored (bfloat16), in float32,
// as F.layer_norm of s.float() computes them, in another order.
//
// Design for this card: the work is bound by memory (2-4 flops a byte), so
// the only gain is fewer bytes.  One warp a row: each lane loads 16-byte
// vectors (8 elements) of the row at vector lane + 32 j, j < VPL (VPL =
// ceil(width / 256), a template parameter, so the row stays in registers as
// packed bfloat16 between the statistics and the write and is read from
// device memory once); the mean and the variance are two warp-shuffle sums.
// weight and bias (float32) are staged in shared memory once a block, split
// into the low and high four of each lane's eight columns so that a warp's
// 16-byte reads fall in distinct banks.  A block of 8 warps walks
// kRowsPerWarp rows a warp, enough warps in flight to keep HBM busy.  The
// width and eps come from the arguments: one code path for every width that
// is a multiple of 8, up to 1280 (ViT-H's; SigLIP SO400M's is 1152, ViT-L's
// 1024).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxVpl = 5;  // vectors a lane: widths up to 5 x 32 x 8 = 1280
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// x, d, s, y: rows x (8 nvec) bfloat16, contiguous, as 16-byte vectors.
// weight, bias: 8 nvec float32.  Dynamic shared memory: 4 nvec float4.
template <int VPL, bool kResid>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ d,
                      const float4* __restrict__ weight, const float4* __restrict__ bias,
                      uint4* __restrict__ s, uint4* __restrict__ y, long long rows, int nvec,
                      float eps) {
  extern __shared__ float4 wb[];  // weight low, weight high, bias low, bias high
  float4* w_lo = wb;
  float4* w_hi = wb + nvec;
  float4* b_lo = wb + 2 * nvec;
  float4* b_hi = wb + 3 * nvec;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    w_lo[i] = weight[2 * i];
    w_hi[i] = weight[2 * i + 1];
    b_lo[i] = bias[2 * i];
    b_hi[i] = bias[2 * i + 1];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const float width = static_cast<float>(8 * nvec);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const long long base = row * nvec;
    uint4 v[VPL];
    uint4 dv[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        v[j] = x[base + c];
        if constexpr (kResid) dv[j] = d[base + c];
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        float f[8];
        unpack8(v[j], f);
        if constexpr (kResid) {
          float g[8];
          unpack8(dv[j], g);
#pragma unroll
          for (int k = 0; k < 8; ++k) f[k] += g[k];
          v[j] = pack8(f);  // s, rounded once
          s[base + c] = v[j];
          unpack8(v[j], f);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += f[k];
      }
    }
    const float mean = warp_sum(sum) / width;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (lane + 32 * j < nvec) {
        float f[8];
        unpack8(v[j], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float t = f[k] - mean;
          sq += t * t;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / width + eps);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        float f[8];
        unpack8(v[j], f);
        const float4 wl = w_lo[c], wh = w_hi[c], bl = b_lo[c], bh = b_hi[c];
        const float w[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
        const float b[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] = (f[k] - mean) * rstd * w[k] + b[k];
        y[base + c] = pack8(f);
      }
    }
  }
}

using Kernel = void (*)(const uint4*, const uint4*, const float4*, const float4*, uint4*, uint4*,
                        long long, int, float);

template <bool kResid>
Kernel pick(int vpl) {
  switch (vpl) {
    case 1: return add_layer_norm_kernel<1, kResid>;
    case 2: return add_layer_norm_kernel<2, kResid>;
    case 3: return add_layer_norm_kernel<3, kResid>;
    case 4: return add_layer_norm_kernel<4, kResid>;
    case 5: return add_layer_norm_kernel<5, kResid>;
    default: return nullptr;
  }
}

// The kernel for a row of `width` elements, or nullptr if the width is not
// a positive multiple of 8 up to 1280.
Kernel kernel_for(int width, bool resid) {
  if (width <= 0 || width % 8 != 0 || width > 8 * 32 * kMaxVpl) return nullptr;
  const int vpl = (width / 8 + 31) / 32;
  return resid ? pick<true>(vpl) : pick<false>(vpl);
}

size_t smem_bytes(int width) { return static_cast<size_t>(width) * 2 * sizeof(float); }

}  // namespace

// s = x + d and y = LayerNorm(s) (d null: y = LayerNorm(x), s untouched) over
// `rows` rows of `width` bfloat16 elements; all four row arrays contiguous and
// 16-byte aligned, weight and bias `width` float32, 16-byte aligned.  Launches
// nothing for no rows.  Returns a cudaError_t (cudaErrorInvalidValue for a
// width the kernel does not take).
extern "C" int add_layer_norm_launch(const void* x, const void* d, const void* weight,
                                     const void* bias, void* s, void* y, long long rows, int width,
                                     float eps, void* stream) {
  const Kernel kernel = kernel_for(width, d != nullptr);
  if (kernel == nullptr || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  constexpr long long kRowsPerBlock = static_cast<long long>(kWarps) * kRowsPerWarp;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* dv = static_cast<const uint4*>(d);
  const float4* wv = static_cast<const float4*>(weight);
  const float4* bv = static_cast<const float4*>(bias);
  uint4* sv = static_cast<uint4*>(s);
  uint4* yv = static_cast<uint4*>(y);
  int nvec = width / 8;
  void* args[] = {&xv, &dv, &wv, &bv, &sv, &yv, &rows, &nvec, &eps};
  const cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                       dim3(kThreads), args, smem_bytes(width), static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// What the compiler says of the kernel a launch at `width` runs: registers,
// local (spill + stack) bytes per thread, static shared bytes, threads a
// block, dynamic shared bytes, rows a block.  Returns a cudaError_t.
extern "C" int add_layer_norm_info(int width, int resid, int* info) {
  const Kernel kernel = kernel_for(width, resid != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = kThreads;
  info[4] = (int)smem_bytes(width);
  info[5] = kWarps * kRowsPerWarp;
  return (int)err;
}
