// Shared pieces of the four walks (K1 bvh8_trace.cu, K3 skip_trace.cu,
// K4 tlas8_trace.cu, K5 tlas_skip_trace.cu): the ray with its slab-test
// terms, the slab test of one box and the instance ray transform (the
// walks read their node records and test triangles through
// skip_common.cuh).  This arithmetic follows the JAX package's:
//   slab_hit        hrt_tpu/ops/traversal_pallas.py `_slab_test` (:215)
//   enter_instance  hrt_tpu/ops/tlas.py `do_enter` (:455-468)
//   safe_inv        the kernels' `inv` (traversal_pallas.py :278-281)
#pragma once

#include <cuda_runtime.h>

namespace hrt {

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

}  // namespace hrt
