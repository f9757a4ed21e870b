// Shared pieces of the four walks (K1 bvh8_trace.cu, K3 skip_trace.cu,
// K4 tlas8_trace.cu, K5 tlas_skip_trace.cu): the ray with its slab-test
// terms, the slab test of one box, K1's BVH8 node reads, the instance
// ray transform and Möller-Trumbore over the (T, 12) v0|e1|e2|pad
// triangle table (K1's; K3, K4 and K5 read their node records and test
// triangles through skip_common.cuh).  This arithmetic follows the JAX
// package's:
//   slab_hit        hrt_tpu/ops/traversal_pallas.py `_slab_test` (:215)
//   moller          hrt_tpu/ops/traversal_pallas.py `_moller` (:236)
//   enter_instance  hrt_tpu/ops/tlas.py `do_enter` (:455-468)
//   safe_inv        the kernels' `inv` (traversal_pallas.py :278-281)
//
// BVH8 record layout (hrt_tpu_torch/ops/wide8.py): child j of wide node q
// is the 8 int32 words at (q / 16) * 1024 + j * 128 + (q % 16) * 8: six
// box floats as bits, the meta word (> 0 leaf payload + 1, < 0 internal
// of rank -(meta + 1), 0 empty), and on slot 0 the id of the node's first
// internal child.  Slots are leaf-first, then internal, then empty.
#pragma once

#include <cuda_runtime.h>

namespace hrt {

constexpr int kRowWords = 1024;   // 16 nodes x 8 slots x 8 words
constexpr int kSlotWords = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oix, oiy, oiz;
};

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = 1e-20f;
  float s = fabsf(c) < tiny ? (c < 0.0f ? -tiny : tiny) : c;
  return 1.0f / s;
}

__device__ __forceinline__ void set_ray(Ray& r, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.oix = ox * r.ix; r.oiy = oy * r.iy; r.oiz = oz * r.iz;
}

// Whether the ray's segment (t_min, t) meets the box (exact per-ray slab
// test; each plane distance is one FMA, bmin * inv_d - o * inv_d).
__device__ __forceinline__ bool slab_hit(float bminx, float bminy,
                                         float bminz, float bmaxx,
                                         float bmaxy, float bmaxz,
                                         const Ray& r, float t_min,
                                         float t) {
  const float tx0 = bminx * r.ix - r.oix;
  const float ty0 = bminy * r.iy - r.oiy;
  const float tz0 = bminz * r.iz - r.oiz;
  const float tx1 = bmaxx * r.ix - r.oix;
  const float ty1 = bmaxy * r.iy - r.oiy;
  const float tz1 = bmaxz * r.iz - r.oiz;
  const float t_near =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
            fmaxf(fminf(tz0, tz1), t_min));
  const float t_far =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
            fminf(fmaxf(tz0, tz1), t));
  return t_near <= t_far;
}

// The 8 words of BVH8 node q, slot 0.
__device__ __forceinline__ const int* node_ptr(const int* rec, int q) {
  return rec + (q >> 4) * kRowWords + (q & 15) * 8;
}

// Child slot j of a BVH8 `node`: two 16-byte loads of its record words.
// Returns its meta word; `hit` is the slab test of its box.
__device__ __forceinline__ int child_test(const int* node, int j,
                                          const Ray& r, float t_min,
                                          float t, bool& hit) {
  const int4* w = reinterpret_cast<const int4*>(node + j * kSlotWords);
  const int4 w0 = __ldg(w);
  const int4 w1 = __ldg(w + 1);
  hit = slab_hit(__int_as_float(w0.x), __int_as_float(w0.y),
                 __int_as_float(w0.z), __int_as_float(w0.w),
                 __int_as_float(w1.x), __int_as_float(w1.y), r, t_min, t);
  return w1.z;
}

// The world ray (wo, wd) into instance `inst`'s object space: three
// 16-byte loads of its 3x4 obj_from_world rows, the affine transform of
// the origin and the linear one of the direction, term for term as the
// JAX kernel (unnormalized, so t stays the world-space parameter).
__device__ __forceinline__ void enter_instance(Ray& r, const float4* tf,
                                               int inst, float wox,
                                               float woy, float woz,
                                               float wdx, float wdy,
                                               float wdz) {
  const float4 a = __ldg(tf + 3 * inst);
  const float4 b = __ldg(tf + 3 * inst + 1);
  const float4 c = __ldg(tf + 3 * inst + 2);
  set_ray(r, a.x * wox + a.y * woy + a.z * woz + a.w,
          b.x * wox + b.y * woy + b.z * woz + b.w,
          c.x * wox + c.y * woy + c.z * woz + c.w,
          a.x * wdx + a.y * wdy + a.z * wdz,
          b.x * wdx + b.y * wdy + b.z * wdz,
          c.x * wdx + c.y * wdy + c.z * wdz);
}

// Möller-Trumbore, term for term as `_moller`: |det| > 1e-12, u, v >= 0,
// u + v <= 1, t_min < t < t_limit.
__device__ __forceinline__ bool moller(const float4* tri, const Ray& r,
                                       float t_min, float t_limit,
                                       float& t, float& u, float& v) {
  const float4 a = __ldg(tri);
  const float4 b = __ldg(tri + 1);
  const float4 c = __ldg(tri + 2);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
         t < t_limit;
}

// Möller-Trumbore over the K triangles of the leaf starting at pool slot
// `start`, in slot order.  A hit below the live t updates (t, best, u, v);
// in any-hit mode the first hit returns true at once (the ray retires).
template <bool CLOSEST>
__device__ __forceinline__ bool leaf_hits(const float4* tris, int start,
                                          int leaf_size, const Ray& r,
                                          float t_min, float& t, int& best,
                                          float& u, float& v) {
  const float4* tp = tris + static_cast<size_t>(start) * 3;
  bool any = false;
  for (int k = 0; k < leaf_size; ++k) {
    float th, uh, vh;
    if (moller(tp + 3 * k, r, t_min, t, th, uh, vh)) {
      best = start + k;
      if (!CLOSEST) return true;
      t = th; u = uh; v = vh;
      any = true;
    }
  }
  return any;
}

}  // namespace hrt
