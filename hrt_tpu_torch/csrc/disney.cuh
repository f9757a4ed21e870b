// Disney BRDF terms as device functions, transcribed term for term from
// hrt_tpu/ops/disney.py (itself the reference's shaders/disney.slang),
// with its quirks kept: GTR1 uses log2; the sheen term ignores the
// material's sheen scale (only sheen_tint is read); the specular Fresnel
// uses schlick_weight(L.H); the anisotropic Smith term squares only
// (v.y * ay) before the n.v^2 factor.
#pragma once

#include <cuda_runtime.h>

namespace disney {

constexpr float kPi = 3.1415926535897f;
constexpr float kOneOverPi = 0.3183098861837f;

struct Vec { float x, y, z; };

// The 12 material planes the BRDF reads (MatP minus emission/ior).
struct Mat {
  Vec color;
  float subsurface, metallic, roughness, specular, specular_tint,
      anisotropic, sheen_tint, clearcoat, clearcoat_gloss;
};

__device__ __forceinline__ float dot(Vec a, Vec b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ Vec normalize(Vec a) {
  const float inv = 1.0f / sqrtf(fmaxf(dot(a, a), 1e-8f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float schlick_fresnel(float f0, float vdoth) {
  const float m = 1.0f - vdoth;
  return f0 + (1.0f - f0) * (m * m * m * m * m);
}

__device__ __forceinline__ float schlick_weight(float f) {
  const float m = clip01(1.0f - f);
  return m * m * m * m * m;
}

__device__ __forceinline__ float gtr1(float ndoth, float a) {
  const float a2 = a * a;
  const float val = (a2 - 1.0f) /
      (kPi * log2f(fmaxf(a2, 1e-8f)) * (1.0f + (a2 - 1.0f) * ndoth * ndoth));
  return a >= 1.0f ? kOneOverPi : val;
}

__device__ __forceinline__ float gtr2_anisotropic(float ndoth, float hdotx,
                                                  float hdoty, float ax,
                                                  float ay) {
  const float sx = hdotx / ax;
  const float sy = hdoty / ay;
  const float s = sx * sx + sy * sy + ndoth * ndoth;
  return 1.0f / (kPi * ax * ay * s * s);
}

__device__ __forceinline__ float smith_ggx(float ndotv, float a) {
  const float a2 = a * a;
  return 2.0f / (1.0f + sqrtf(a2 + (1.0f - a2) * ndotv * ndotv));
}

__device__ __forceinline__ float smith_ggx_anisotropic(float ndotv,
                                                       float vdotx,
                                                       float vdoty,
                                                       float ax, float ay) {
  const float px = vdotx * ax;
  const float py = vdoty * ay;
  return 1.0f / (ndotv + sqrtf(px * px + py * py * ndotv * ndotv));
}

__device__ __forceinline__ Vec calculate_tint(Vec c) {
  const float lum = 0.3f * c.x + 0.6f * c.y + 1.0f * c.z;
  if (!(lum > 0.0f)) return {1.0f, 1.0f, 1.0f};
  const float inv = 1.0f / fmaxf(lum, 1e-12f);
  return {c.x * inv, c.y * inv, c.z * inv};
}

// Tangent frame of n (Frisvad, with the z < -1 guard of
// hrt_tpu/ops/v3.py `orthonormal_basis`); returns v in that frame.
__device__ __forceinline__ Vec to_local(Vec v, Vec n) {
  Vec t, bt;
  if (n.z < -0.99998796f) {
    t = {0.0f, -1.0f, 0.0f};
    bt = {-1.0f, 0.0f, 0.0f};
  } else {
    const float a = 1.0f / (1.0f + n.z);
    const float b = -n.x * n.y * a;
    t = {1.0f - n.x * n.x * a, b, -n.x};
    bt = {b, 1.0f - n.y * n.y * a, -n.y};
  }
  return {dot(v, t), dot(v, bt), dot(v, n)};
}

__device__ __forceinline__ float eval_diffuse(const Mat& m, Vec ll, Vec lv,
                                              Vec lh) {
  const float rough = m.roughness;
  const float fl = schlick_weight(ll.z);
  const float fv = schlick_weight(lv.z);
  const float hdotl = dot(lh, ll);
  const float fd90 = 0.5f + 2.0f * rough * hdotl * hdotl;
  const float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);
  const float fss90 = hdotl * hdotl * rough;
  const float fss =
      (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
  const float lz_vz = ll.z + lv.z;
  const float ss = 1.25f * (fss * (1.0f / fmaxf(lz_vz, 1e-6f) - 0.5f) + 0.5f);
  return fd + (ss - fd) * m.subsurface;
}

__device__ __forceinline__ Vec eval_specular(const Mat& m, Vec lh, Vec lv,
                                             Vec ll) {
  const float aspect = sqrtf(1.0f - m.anisotropic * 0.9f);
  const float r2 = m.roughness * m.roughness;
  const float ax = fmaxf(1e-3f, r2 / aspect);
  const float ay = fmaxf(1e-3f, r2 * aspect);
  const Vec tint = calculate_tint(m.color);
  const float sc = m.specular * 0.08f;
  const Vec base = {(1.0f + (tint.x - 1.0f) * m.specular_tint) * sc,
                    (1.0f + (tint.y - 1.0f) * m.specular_tint) * sc,
                    (1.0f + (tint.z - 1.0f) * m.specular_tint) * sc};
  const Vec color = {base.x + (m.color.x - base.x) * m.metallic,
                     base.y + (m.color.y - base.y) * m.metallic,
                     base.z + (m.color.z - base.z) * m.metallic};
  const float d = gtr2_anisotropic(lh.z, lh.x, lh.y, ax, ay);
  const float fresnel = schlick_weight(dot(ll, lh));
  const float g = smith_ggx_anisotropic(ll.z, ll.x, ll.y, ax, ay) *
                  smith_ggx_anisotropic(lv.z, lv.x, lv.y, ax, ay);
  const float dg = d * g;
  return {(color.x + (1.0f - color.x) * fresnel) * dg,
          (color.y + (1.0f - color.y) * fresnel) * dg,
          (color.z + (1.0f - color.z) * fresnel) * dg};
}

// f(mat, n, v, l); zero unless n.l > 0 and n.v > 0 (the reference's
// early-out).  v points toward the viewer, l toward the light.
__device__ __forceinline__ Vec brdf(const Mat& m, Vec n, Vec v, Vec l) {
  const float ndotl = dot(n, l);
  const float ndotv = dot(n, v);
  if (!(ndotl > 0.0f && ndotv > 0.0f)) return {0.0f, 0.0f, 0.0f};
  const Vec h = normalize({v.x + l.x, v.y + l.y, v.z + l.z});
  const float ndoth = dot(n, h);
  const float hdotl = dot(h, l);
  const Vec lh = to_local(h, n);
  const Vec lv = to_local(v, n);
  const Vec ll = to_local(l, n);

  const Vec tint = calculate_tint(m.color);
  const float sw = schlick_weight(hdotl);
  const Vec sheen = {(1.0f + (tint.x - 1.0f) * m.sheen_tint) * sw,
                     (1.0f + (tint.y - 1.0f) * m.sheen_tint) * sw,
                     (1.0f + (tint.z - 1.0f) * m.sheen_tint) * sw};

  const float cd = gtr1(ndoth, 0.1f + (-0.099f) * m.clearcoat_gloss);
  const float cf = schlick_fresnel(0.04f, hdotl);
  const float cg = smith_ggx(ndotl, 0.25f) * smith_ggx(ndotv, 0.25f);
  const float clearcoat = 0.25f * m.clearcoat * cd * cf * cg;

  const Vec spec = eval_specular(m, lh, lv, ll);
  const float diffuse = eval_diffuse(m, ll, lv, lh);
  const float kd = kOneOverPi * diffuse;
  const float one_minus_metal = 1.0f - m.metallic;
  return {(m.color.x * kd + sheen.x) * one_minus_metal + spec.x + clearcoat,
          (m.color.y * kd + sheen.y) * one_minus_metal + spec.y + clearcoat,
          (m.color.z * kd + sheen.z) * one_minus_metal + spec.z + clearcoat};
}

}  // namespace disney
