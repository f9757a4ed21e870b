// The walks' node reads, staging and triangle test: K3 (skip_trace.cu),
// K5 (tlas_skip_trace.cu), K4 (tlas8_trace.cu) and K1 (bvh8_trace.cu).
//
// Node record (hrt_tpu_torch/ops/traversal_skip.py `skip_records`): node
// i of the skip-link table (hrt_tpu_torch/ops/lbvh.py `flatten_bvh`, the
// JAX FlatBVH, word c of node i at (i / 128) * 1024 + c * 128 + i % 128)
// as the 8 int32 words at rec + 8 * i -- six box floats as bits, the
// leaf code (0 internal, else the leaf's first pool slot + 1; in a
// two-level TLAS -(instance + 1)) and the skip index (the node after its
// subtree) -- so a node is two 16-byte loads instead of eight 4-byte
// loads 512 bytes apart.
//
// Triangle test: Möller-Trumbore without a division on the way to a miss.
// It computes det, T.P, D.Q and E2.Q term for term as the JAX package's
// `_moller` (hrt_tpu/ops/traversal_pallas.py :236: |det| > 1e-12, u, v
// >= 0, u + v <= 1, t_min < t < t_live) and compares them scaled by |det|
// and sign(det) (u.det, v.det, (u+v).det against |det|, t.det against
// t_min.|det| and t_live.|det|), the u range first, so a warp whose rays
// all pass beside the triangle skips Q, v and t.  Only a triangle that
// passes every comparison takes the reciprocal; its t, u and v are then
// `_moller`'s own products, held to `_moller`'s own conditions, so the
// accepted set is a subset of `_moller`'s and differs from it only for
// hits within rounding of an edge, of t_min or of t_live.
// traversal_skip.moller_scaled is its plain mirror.
#pragma once

#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace hrt {

// Skip-link node i from its 32-byte record: the slab test of its box;
// sets its leaf code and skip.
__device__ __forceinline__ bool skip_rec_test(const int4* __restrict__ rec,
                                              int i, const Ray& r,
                                              float t_min, float t,
                                              int& code, int& skip) {
  const int4 w0 = __ldg(rec + 2 * i);
  const int4 w1 = __ldg(rec + 2 * i + 1);
  code = w1.z;
  skip = w1.w;
  return slab_hit(__int_as_float(w0.x), __int_as_float(w0.y),
                  __int_as_float(w0.z), __int_as_float(w0.w),
                  __int_as_float(w1.x), __int_as_float(w1.y), r, t_min, t);
}

// slab_hit (walk_common.cuh), term for term, also giving the entry
// distance t_near (>= t_min) for a nearest-first order.
__device__ __forceinline__ bool slab_entry(float bminx, float bminy,
                                           float bminz, float bmaxx,
                                           float bmaxy, float bmaxz,
                                           const Ray& r, float t_min,
                                           float t, float& t_near) {
  const float tx0 = bminx * r.ix - r.oix;
  const float ty0 = bminy * r.iy - r.oiy;
  const float tz0 = bminz * r.iz - r.oiz;
  const float tx1 = bmaxx * r.ix - r.oix;
  const float ty1 = bmaxy * r.iy - r.oiy;
  const float tz1 = bmaxz * r.iz - r.oiz;
  t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                 fmaxf(fminf(tz0, tz1), t_min));
  const float t_far =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
            fminf(fmaxf(tz0, tz1), t));
  return t_near <= t_far;
}

// The warp copies triangles start .. start + kn - 1 (kn <= 32) of the
// (T, 12) pool into its 32 * 3 float4 of shared memory, lane k triangle
// k (three coalesced 16-byte loads); the warp's lanes may then read them.
__device__ __forceinline__ void stage_tris(float4* st,
                                           const float4* __restrict__ tris,
                                           int start, int kn, int lane) {
  __syncwarp();  // the last chunk's reads are done
  if (lane < kn) {
    const float4* src = tris + static_cast<size_t>(start + lane) * 3;
    st[3 * lane] = __ldg(src);
    st[3 * lane + 1] = __ldg(src + 1);
    st[3 * lane + 2] = __ldg(src + 2);
  }
  __syncwarp();
}

// x * sign(s) for the sign bit `s` of det (0 or 0x80000000).
__device__ __forceinline__ float flip(float x, unsigned s) {
  return __uint_as_float(__float_as_uint(x) ^ s);
}

// The division-free test of one triangle, given as its three table rows
// (v0.xyz e1.x | e1.yz e2.xy | e2.z pad).
__device__ __forceinline__ bool moller_scaled(float4 a, float4 b, float4 c,
                                              const Ray& r, float t_min,
                                              float t_limit, float& t,
                                              float& u, float& v) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float uu = tx * px + ty * py + tz * pz;
  const unsigned s = __float_as_uint(det) & 0x80000000u;
  const float adet = fabsf(det);
  const float su = flip(uu, s);
  if (!(adet > 1e-12f && su >= 0.0f && su <= adet)) return false;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vv = r.dx * qx + r.dy * qy + r.dz * qz;
  const float tt = e2x * qx + e2y * qy + e2z * qz;
  const float sv = flip(vv, s), st = flip(tt, s);
  if (!(sv >= 0.0f && su + sv <= adet && st > t_min * adet &&
        st < t_limit * adet))
    return false;
  const float inv_det = 1.0f / det;
  u = uu * inv_det;
  v = vv * inv_det;
  t = tt * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
         t < t_limit;
}

}  // namespace hrt
