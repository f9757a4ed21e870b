// Disney BRDF terms as device functions, transcribed term for term from
// hrt_tpu/ops/disney.py (itself the reference's shaders/disney.slang),
// with its quirks kept: GTR1 uses log2; the sheen term ignores the
// material's sheen scale (only sheen_tint is read); the specular Fresnel
// uses schlick_weight(L.H); the anisotropic Smith term squares only
// (v.y * ay) before the n.v^2 factor.  The terms that depend on the view
// alone are split out (`view_terms`), so that a ray's lights share them;
// each is the same expression as before the split.
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

// Dot products and GTR1's denominator round every product and sum as
// the plain version's separate tensor ops do (no FMA contraction): at a
// clearcoat highlight 1 + (a^2 - 1) n.h^2 cancels to ~a^2, so one
// rounding of n.h there moves f by more than 1e-4.
__device__ __forceinline__ float dot(Vec a, Vec b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
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
  const float a2 = __fmul_rn(a, a);
  const float t = __fadd_rn(
      1.0f, __fmul_rn(__fmul_rn(__fadd_rn(a2, -1.0f), ndoth), ndoth));
  const float val =
      (a2 - 1.0f) / (__fmul_rn(kPi * log2f(fmaxf(a2, 1e-8f)), t));
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
// hrt_tpu/ops/v3.py `orthonormal_basis`).
struct Frame { Vec t, bt, n; };

__device__ __forceinline__ Frame tangent_frame(Vec n) {
  if (n.z < -0.99998796f) return {{0.0f, -1.0f, 0.0f}, {-1.0f, 0.0f, 0.0f}, n};
  const float a = 1.0f / (1.0f + n.z);
  const float b = -n.x * n.y * a;
  return {{1.0f - n.x * n.x * a, b, -n.x}, {b, 1.0f - n.y * n.y * a, -n.y}, n};
}

// v in the frame.
__device__ __forceinline__ Vec to_local(Vec v, const Frame& f) {
  return {dot(v, f.t), dot(v, f.bt), dot(v, f.n)};
}

// The terms of f(mat, n, v, l) that do not depend on l, computed once per
// ray for all of its lights: the tangent frame, v in it, n.v, the
// diffuse Fresnel weight of v, the tint, the specular colour and
// roughnesses, and the Smith terms of v (specular and clearcoat).
struct ViewTerms {
  Frame f;
  Vec v, lv, tint, spec_color;
  float ndotv, fv, ax, ay, spec_gv, coat_gv, coat_a;
};

__device__ __forceinline__ ViewTerms view_terms(const Mat& m, Vec n, Vec v) {
  ViewTerms w;
  w.f = tangent_frame(n);
  w.v = v;
  w.ndotv = dot(n, v);
  w.lv = to_local(v, w.f);
  w.fv = schlick_weight(w.lv.z);
  w.tint = calculate_tint(m.color);
  const float aspect = sqrtf(1.0f - m.anisotropic * 0.9f);
  const float r2 = m.roughness * m.roughness;
  w.ax = fmaxf(1e-3f, r2 / aspect);
  w.ay = fmaxf(1e-3f, r2 * aspect);
  const float sc = m.specular * 0.08f;
  const Vec base = {(1.0f + (w.tint.x - 1.0f) * m.specular_tint) * sc,
                    (1.0f + (w.tint.y - 1.0f) * m.specular_tint) * sc,
                    (1.0f + (w.tint.z - 1.0f) * m.specular_tint) * sc};
  w.spec_color = {base.x + (m.color.x - base.x) * m.metallic,
                  base.y + (m.color.y - base.y) * m.metallic,
                  base.z + (m.color.z - base.z) * m.metallic};
  w.spec_gv = smith_ggx_anisotropic(w.lv.z, w.lv.x, w.lv.y, w.ax, w.ay);
  w.coat_gv = smith_ggx(w.ndotv, 0.25f);
  w.coat_a = __fadd_rn(0.1f, __fmul_rn(-0.099f, m.clearcoat_gloss));
  return w;
}

__device__ __forceinline__ float eval_diffuse(const Mat& m,
                                              const ViewTerms& w, Vec ll,
                                              Vec lh) {
  const float rough = m.roughness;
  const float fl = schlick_weight(ll.z);
  const float fv = w.fv;
  const float hdotl = dot(lh, ll);
  const float fd90 = 0.5f + 2.0f * rough * hdotl * hdotl;
  const float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);
  const float fss90 = hdotl * hdotl * rough;
  const float fss =
      (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
  const float lz_vz = ll.z + w.lv.z;
  const float ss = 1.25f * (fss * (1.0f / fmaxf(lz_vz, 1e-6f) - 0.5f) + 0.5f);
  return fd + (ss - fd) * m.subsurface;
}

__device__ __forceinline__ Vec eval_specular(const ViewTerms& w, Vec lh,
                                             Vec ll) {
  const float d = gtr2_anisotropic(lh.z, lh.x, lh.y, w.ax, w.ay);
  const float fresnel = schlick_weight(dot(ll, lh));
  const float g =
      smith_ggx_anisotropic(ll.z, ll.x, ll.y, w.ax, w.ay) * w.spec_gv;
  const float dg = d * g;
  const Vec c = w.spec_color;
  return {(c.x + (1.0f - c.x) * fresnel) * dg,
          (c.y + (1.0f - c.y) * fresnel) * dg,
          (c.z + (1.0f - c.z) * fresnel) * dg};
}

// f(mat, n, v, l) from the ray's view terms; zero unless n.l > 0 and
// n.v > 0 (the reference's early-out).  v points toward the viewer, l
// toward the light.
__device__ __forceinline__ Vec brdf(const Mat& m, const ViewTerms& w,
                                    Vec l) {
  const Vec n = w.f.n, v = w.v;
  const float ndotl = dot(n, l);
  if (!(ndotl > 0.0f && w.ndotv > 0.0f)) return {0.0f, 0.0f, 0.0f};
  const Vec h = normalize({v.x + l.x, v.y + l.y, v.z + l.z});
  const float ndoth = dot(n, h);
  const float hdotl = dot(h, l);
  const Vec lh = to_local(h, w.f);
  const Vec ll = to_local(l, w.f);

  const float sw = schlick_weight(hdotl);
  const Vec sheen = {(1.0f + (w.tint.x - 1.0f) * m.sheen_tint) * sw,
                     (1.0f + (w.tint.y - 1.0f) * m.sheen_tint) * sw,
                     (1.0f + (w.tint.z - 1.0f) * m.sheen_tint) * sw};

  const float cd = gtr1(ndoth, w.coat_a);
  const float cf = schlick_fresnel(0.04f, hdotl);
  const float cg = smith_ggx(ndotl, 0.25f) * w.coat_gv;
  const float clearcoat = 0.25f * m.clearcoat * cd * cf * cg;

  const Vec spec = eval_specular(w, lh, ll);
  const float diffuse = eval_diffuse(m, w, ll, lh);
  const float kd = kOneOverPi * diffuse;
  const float one_minus_metal = 1.0f - m.metallic;
  return {(m.color.x * kd + sheen.x) * one_minus_metal + spec.x + clearcoat,
          (m.color.y * kd + sheen.y) * one_minus_metal + spec.y + clearcoat,
          (m.color.z * kd + sheen.z) * one_minus_metal + spec.z + clearcoat};
}

}  // namespace disney
