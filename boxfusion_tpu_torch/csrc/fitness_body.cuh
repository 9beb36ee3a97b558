// The per-particle body of the multi-view fitness: |1 - IoU| of one PST
// particle's projected hull against one view's observed polygon.
//
// Shared by csrc/fitness_kernel.cu (one iteration's fitness, one thread per
// (cell, particle)) and csrc/pst_search_kernel.cu (the whole PST search).
// The arithmetic follows the TPU kernel's body
// (boxfusion_tpu/ops/fitness_kernel.py:_fitness_cell_body) operation for
// operation; its plain PyTorch twin is
// boxfusion_tpu_torch/ops/fitness_kernel.py:fitness_cells_reference.  Stages:
//   A) the 28 all-pairs candidate half-planes of the 8 projected corners,
//      each with a magnitude-scaled tolerance, and the hull-vertex flags;
//   B) the hull anchor, centroid and "diamond angle" sort key;
//   C) a 19-comparator Batcher sort of the hull vertices;
//   D) the candidate hull's shoelace area;
//   E) the Green's-theorem integral of the candidate hull's edges clipped by
//      the observed polygon's <= 12 planes (inclusive boundary);
//   F) the integral of the observed hull's edges clipped by the candidate's
//      28 planes (exclusive boundary), fused into stage A: each candidate
//      plane updates the 8 observed-hull edges' clip intervals as soon as it
//      is known, so no plane and no side value outlives its loop iteration
//      (the interval updates are max / min / or, so the reordering is exact);
//   G) |1 - IoU|.
// Every loop has compile-time bounds and is fully unrolled, so all small
// arrays are indexed statically (registers).  Built with -fmad=false and
// IEEE division (ops/build.py): every product rounds on its own, as in the
// twin.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fitness {

constexpr int kObsPlanes = 12;
constexpr float kEps = 1e-9f;

__device__ __forceinline__ void cmp_swap(float* key, float* px, float* py, int a, int b) {
  const float ka = key[a], kb = key[b];
  const bool sw = ka > kb;
  key[a] = sw ? kb : ka;
  key[b] = sw ? ka : kb;
  const float xa = px[a], xb = px[b];
  px[a] = sw ? xb : xa;
  px[b] = sw ? xa : xb;
  const float ya = py[a], yb = py[b];
  py[a] = sw ? yb : ya;
  py[b] = sw ? ya : yb;
}

// One half-plane's update of the clip intervals [t0, t1] of the 8 closed-
// polygon edges whose vertex sides are s[0..7] (Liang-Barsky).  Vertices
// with s >= th are inside.
__device__ __forceinline__ void clip_edges(const float* s, float th, float* t0, float* t1,
                                           uint32_t* empty) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int e2 = (e + 1) & 7;
    const float sp = s[e], sq = s[e2];
    const bool in_p = sp >= th;
    const bool in_q = sq >= th;
    float denom = sp - sq;
    if (fabsf(denom) < kEps) denom = kEps;
    const float tstar = (sp - th) / denom;
    if (!in_p && in_q) t0[e] = fmaxf(t0[e], tstar);
    if (in_p && !in_q) t1[e] = fminf(t1[e], tstar);
    if (!in_p && !in_q) *empty |= 1u << e;
  }
}

// Sum over the 8 edges of cross(p(t0), p(t1)) for non-empty clipped edges.
__device__ __forceinline__ float boundary_integral(const float* px, const float* py,
                                                   const float* t0, const float* t1,
                                                   uint32_t empty, float integral,
                                                   bool first) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int e2 = (e + 1) & 7;
    const float exv = px[e2] - px[e];
    const float eyv = py[e2] - py[e];
    const float ax1 = px[e] + t0[e] * exv;
    const float ay1 = py[e] + t0[e] * eyv;
    const float bx1 = px[e] + t1[e] * exv;
    const float by1 = py[e] + t1[e] * eyv;
    float contrib = ax1 * by1 - bx1 * ay1;
    if (((empty >> e) & 1u) || t0[e] >= t1[e]) contrib = 0.f;
    integral = (first && e == 0) ? contrib : integral + contrib;
  }
  return integral;
}

// |1 - IoU| of the hull of the 8 corners (U[k], V[k]), centred on the view,
// against the view's observed polygon: hull (8 x 2, centred), planes
// (12 x [nx, ny, d]), pvalid (12) and area, all in shared memory.
__device__ __forceinline__ float particle_error(const float (&U)[8], const float (&V)[8],
                                                const float* hull, const float* planes,
                                                const float* pvalid, float area_b) {
  float ohx[8], ohy[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ohx[k] = hull[2 * k];
    ohy[k] = hull[2 * k + 1];
  }

  // ---- A) candidate half-planes + vertex flags, with F's clipping fused --
  uint32_t flags = 0;
  bool any_valid = false;
  float t0b[8], t1b[8];
  uint32_t emptyb = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    t0b[e] = 0.f;
    t1b[e] = 1.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      const float ex = U[j] - U[i];
      const float ey = V[j] - V[i];
      float ss[8];
      float smin = 0.f, smax = 0.f, mrel = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float du = U[k] - U[i];
        const float dv = V[k] - V[i];
        const float s = ex * dv - ey * du;
        ss[k] = s;
        const float m = fmaxf(fabsf(du), fabsf(dv));
        smin = k == 0 ? s : fminf(smin, s);
        smax = k == 0 ? s : fmaxf(smax, s);
        mrel = k == 0 ? m : fmaxf(mrel, m);
      }
      const float me = fmaxf(fabsf(ex), fabsf(ey));
      const float tol = 2e-5f * mrel * me + kEps;
      const bool nondeg = ex * ex + ey * ey > kEps;
      const bool nonneg = smin >= -tol;
      const bool nonpos = smax <= tol;
      const bool valid = nondeg && (nonneg || nonpos);
      any_valid = any_valid || valid;
      if (valid) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (fabsf(ss[k]) <= tol) flags |= 1u << k;
        }
        const float sign = nonneg ? 1.f : -1.f;
        const float nx = -ey * sign;
        const float ny = ex * sign;
        const float d = -(nx * U[i] + ny * V[i]);
        // F) this plane clips the observed hull's edges (exclusive boundary)
        float sb[8];
        float amax = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sb[k] = nx * ohx[k] + ny * ohy[k] + d;
          amax = k == 0 ? fabsf(sb[k]) : fmaxf(amax, fabsf(sb[k]));
        }
        clip_edges(sb, 2e-5f * amax + kEps, t0b, t1b, &emptyb);
      }
    }
  }

  // ---- B) anchor, centroid, diamond-angle key ------------------------------
  if (!any_valid) flags = 0xFFu;  // fully degenerate sets keep all vertices
  float ax = U[0], ay = V[0];
  bool found = flags & 1u;
  float cnt = (float)(flags & 1u);
  float sx = (flags & 1u) ? U[0] : 0.f;
  float sy = (flags & 1u) ? V[0] : 0.f;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const bool fk = (flags >> k) & 1u;
    if (fk && !found) {
      ax = U[k];
      ay = V[k];
    }
    found = found || fk;
    cnt = cnt + (fk ? 1.f : 0.f);
    sx = sx + (fk ? U[k] : 0.f);
    sy = sy + (fk ? V[k] : 0.f);
  }
  const float cx = sx / fmaxf(cnt, 1.f);
  const float cy = sy / fmaxf(cnt, 1.f);

  float key[8], px[8], py[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool fk = (flags >> k) & 1u;
    const float fx = fk ? U[k] : ax;
    const float fy = fk ? V[k] : ay;
    px[k] = fx;
    py[k] = fy;
    const float dx = fx - cx;
    const float dy = fy - cy;
    const float r = fabsf(dx) + fabsf(dy);
    const float a = dx / (r < kEps ? 1.f : r);
    key[k] = dy >= 0.f ? 1.f - a : 3.f + a;
  }

  // ---- C) angular sort (Batcher odd-even merge network, 19 comparators) ---
  cmp_swap(key, px, py, 0, 1); cmp_swap(key, px, py, 2, 3);
  cmp_swap(key, px, py, 4, 5); cmp_swap(key, px, py, 6, 7);
  cmp_swap(key, px, py, 0, 2); cmp_swap(key, px, py, 1, 3);
  cmp_swap(key, px, py, 4, 6); cmp_swap(key, px, py, 5, 7);
  cmp_swap(key, px, py, 1, 2); cmp_swap(key, px, py, 5, 6);
  cmp_swap(key, px, py, 0, 4); cmp_swap(key, px, py, 1, 5);
  cmp_swap(key, px, py, 2, 6); cmp_swap(key, px, py, 3, 7);
  cmp_swap(key, px, py, 2, 4); cmp_swap(key, px, py, 3, 5);
  cmp_swap(key, px, py, 1, 2); cmp_swap(key, px, py, 3, 4);
  cmp_swap(key, px, py, 5, 6);

  // ---- D) candidate hull area -----------------------------------------------
  float area_a = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int k2 = (k + 1) & 7;
    const float t = px[k] * py[k2] - px[k2] * py[k];
    area_a = k == 0 ? t : area_a + t;
  }
  area_a = fabsf(area_a) * 0.5f;

  // ---- E) candidate hull edges clipped by the observed planes (inclusive) --
  float t0a[8], t1a[8];
  uint32_t emptya = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    t0a[e] = 0.f;
    t1a[e] = 1.f;
  }
#pragma unroll
  for (int q = 0; q < kObsPlanes; ++q) {
    const float nx = planes[3 * q], ny = planes[3 * q + 1], d = planes[3 * q + 2];
    float sa[8];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sa[k] = nx * px[k] + ny * py[k] + d;
      amax = k == 0 ? fabsf(sa[k]) : fmaxf(amax, fabsf(sa[k]));
    }
    if (pvalid[q] > 0.5f) clip_edges(sa, -(2e-5f * amax + kEps), t0a, t1a, &emptya);
  }
  float integral = boundary_integral(px, py, t0a, t1a, emptya, 0.f, true);

  // ---- F) observed hull edges, clipped in stage A (exclusive) --------------
  integral = boundary_integral(ohx, ohy, t0b, t1b, emptyb, integral, false);

  // ---- G) IoU + error ---------------------------------------------------------
  float inter = fmaxf(integral * 0.5f, 0.f);
  inter = fminf(inter, fminf(area_a, area_b));
  const float uni = area_a + area_b - inter;
  const float iou = uni > 0.f ? inter / (uni + 1e-5f) : 0.f;
  return fabsf(1.f - iou);
}

}  // namespace fitness
