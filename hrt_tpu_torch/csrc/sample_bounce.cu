// The path tracer's bounce stage (K7): one thread per lane of
// renderer.trace_paths' wavefront samples the next direction by lobe,
// draws its PCG words, updates the throughput, offsets the origin and
// plays Russian roulette, in one launch a depth.
//
// Replaces no Pallas kernel: the JAX package leaves the bounce
// (hrt_tpu/renderer.py `_sample_bounce_p` and the roulette lines of
// `trace_paths`) to XLA, which fuses it into a few loops.  Run as plain
// torch, the same stage is ~570 one-op kernels over every lane (each
// int64 PCG step splits its products into 16-bit halves), each a pass
// over device memory.  The stage's work is small: per lane it reads the
// 8 material fields, normal, view, world position, throughput, the seed
// and three flags (~91 B) and writes origin, direction, throughput, the
// seed and `active` (45 B), so it is bound by those ~136 B a lane
// (0.084 ms at 1080p at 3.35 TB/s).  Here:
// - one pass: every intermediate stays in registers, the PCG and hash
//   steps run as uint32 arithmetic, and nothing is written but the
//   outputs (no scratch);
// - the wrapper passes each input plane as (pointer, element stride) in
//   one argument block (`BounceArgs`, by value), so the material fields,
//   strided rows of the frame's attribute gather, are read where they
//   lie and a lane's 8 fields share the cache lines of its row;
// - every lane is computed, live or not, exactly as the plain version
//   (ops/bounce_kernel.py `sample_bounce_plain`) computes it on the card:
//   this file is compiled with -fmad=false (kernels/build.py
//   FILE_FLAGS), so each product and sum rounds on its own as in torch's
//   one-op-a-kernel sequence; sqrtf and the divisions are IEEE-rounded,
//   sinf and cosf are the CUDA math library's, as torch's kernels call
//   them; clamps and maxima propagate NaN as torch's do; and the
//   constants are the Python doubles rounded to float.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 20;
constexpr int kFlags = 3;

// Python's float constants, rounded from double as torch rounds a
// scalar operand.
#define F32(x) static_cast<float>(x)

}  // namespace

// The argument block: float planes 0-19 of N lanes, in this order:
// color xyz, metallic, roughness, anisotropic, ior, transmission,
// normal xyz, view xyz, world position xyz, throughput xyz; element i of
// plane k at plane[k] + i * stride[k].  `seed` the int64 words (a uint32
// value each), `flag` the bool planes entering, hit, active.  `out` 9
// contiguous planes of N floats (origin xyz, direction xyz, throughput
// xyz), `seed_out` N int64 words, `active_out` N bools.
struct BounceArgs {
  const float* plane[kPlanes];
  long long stride[kPlanes];
  const long long* seed;
  long long seed_stride;
  const unsigned char* flag[kFlags];
  long long flag_stride[kFlags];
  float* out;
  long long* seed_out;
  unsigned char* active_out;
  int n;
  int roulette;
  float bounce_offset;
  float roughness_min;
};

namespace {

struct Vec {
  float x, y, z;
};

// torch's clamp / clamp_min / maximum on the card: NaN in, NaN out.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float dot(Vec a, Vec b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ Vec scale(Vec a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

__device__ __forceinline__ Vec select(bool c, Vec a, Vec b) {
  return c ? a : b;
}

// v3.normalize: a times 1 / sqrt(max(|a|^2, 1e-8)).
__device__ __forceinline__ Vec normalize(Vec a) {
  return scale(a, 1.0f / sqrtf(clamp_min(dot(a, a), F32(1e-8))));
}

// v3.to_world: tangent * x + bitangent * y + normal * z.
__device__ __forceinline__ Vec to_world(Vec v, Vec t, Vec b, Vec n) {
  return {t.x * v.x + b.x * v.y + n.x * v.z,
          t.y * v.x + b.y * v.y + n.y * v.z,
          t.z * v.x + b.z * v.y + n.z * v.z};
}

// disney.schlick_weight.
__device__ __forceinline__ float schlick_weight(float f) {
  const float m = clamp(1.0f - f, 0.0f, 1.0f);
  return m * m * m * m * m;
}

// ops/rng.py `rand`: one PCG32 step (the new state is `prev`, the word
// is `prev`'s output) and the word in float32, rounded to nearest, times
// float32(1 / (2^32 - 1)).
__device__ __forceinline__ float rand(uint32_t& state) {
  const uint32_t prev = state * 747796405u + 2891336453u;
  uint32_t w = ((prev >> ((prev >> 28u) + 4u)) ^ prev) * 277803737u;
  w = (w >> 22u) ^ w;
  state = prev;
  return __uint2float_rn(w) * F32(1.0 / 4294967295.0);
}

__global__ void __launch_bounds__(kThreads)
sample_bounce_kernel(const BounceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const auto at = [&](int k) { return __ldg(a.plane[k] + i * a.stride[k]); };
  const auto flag = [&](int k) {
    return __ldg(a.flag[k] + i * a.flag_stride[k]) != 0;
  };
  const Vec color = {at(0), at(1), at(2)};
  const float metallic = at(3), roughness = at(4), anisotropic = at(5);
  const float ior_in = at(6), transmission = at(7);
  const Vec n = {at(8), at(9), at(10)};
  const Vec view = {at(11), at(12), at(13)};
  const Vec wp = {at(14), at(15), at(16)};
  const Vec thr_in = {at(17), at(18), at(19)};
  uint32_t s = static_cast<uint32_t>(__ldg(a.seed + i * a.seed_stride));
  const bool entering = flag(0), hit = flag(1), active = flag(2);

  // v3.orthonormal_basis (branch-free Frisvad, z < -1 guarded).
  const bool degenerate = n.z < F32(-0.99998796);
  const float safe_nz = degenerate ? 0.0f : n.z;
  const float ba = 1.0f / (safe_nz + 1.0f);
  const float bb = -n.x * n.y * ba;
  const Vec tg = {degenerate ? 0.0f : 1.0f - n.x * n.x * ba,
                  degenerate ? -1.0f : bb, degenerate ? 0.0f : -n.x};
  const Vec bt = {degenerate ? -1.0f : bb,
                  degenerate ? 0.0f : 1.0f - n.y * n.y * ba,
                  degenerate ? 0.0f : -n.y};

  // ops/bounce_kernel._sample_bounce_p: draws u0, u1, the lobe.
  const float u0 = rand(s);
  const float u1 = rand(s);
  const float usel = rand(s);
  const float rough = clamp_min(roughness, a.roughness_min);
  const float ior = clamp_min(ior_in, F32(1.0001));
  const float p_spec =
      clamp(metallic + (1.0f - rough) * 0.25f, 0.0f, F32(0.95));

  // sampling.ggx_vndf_spherical_cap_p.
  const Vec wo = {dot(view, tg), dot(view, bt), dot(view, n)};
  const float aspect = sqrtf(1.0f - anisotropic * F32(0.9));
  const float r2 = rough * rough;
  const float ax = clamp_min(r2 / aspect, F32(1e-3));
  const float ay = clamp_min(r2 * aspect, F32(1e-3));
  const Vec v = normalize({ax * wo.x, ay * wo.y, wo.z});
  const float lensq = v.x * v.x + v.y * v.y;
  const bool ok = lensq > F32(1e-12);
  const float rs = ok ? 1.0f / sqrtf(clamp_min(lensq, F32(1e-12))) : 0.0f;
  const Vec t1 = {ok ? -v.y * rs : 1.0f, ok ? v.x * rs : 0.0f, 0.0f};
  const Vec t2 = {v.y * t1.z - v.z * t1.y, v.z * t1.x - v.x * t1.z,
                  v.x * t1.y - v.y * t1.x};
  const float phi = u1 * F32(6.2831853071795);
  const float cos_phi = cosf(phi), sin_phi = sinf(phi);
  const float r = sqrtf(u0);
  const float p1 = r * cos_phi;
  const float sh = (v.z + 1.0f) * 0.5f;
  const float p2 = (1.0f - sh) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) +
                   sh * (r * sin_phi);
  const float nz = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const Vec nh = {t1.x * p1 + t2.x * p2 + v.x * nz,
                  t1.y * p1 + t2.y * p2 + v.y * nz,
                  t1.z * p1 + t2.z * p2 + v.z * nz};
  const Vec wm = normalize({ax * nh.x, ay * nh.y, clamp_min(nh.z, 0.0f)});
  const float k = dot(wo, wm) * 2.0f;
  const Vec wi = {wm.x * k - wo.x, wm.y * k - wo.y, wm.z * k - wo.z};
  // G2 / G1 (sampling._vndf_ratio_p).
  const float a2 = r2 * r2;
  const float f1 = sqrtf(a2 + (1.0f - a2) * wi.z * wi.z);
  const float f2 = sqrtf(a2 + (1.0f - a2) * wo.z * wo.z);
  const float g1 = wo.z * 2.0f / clamp_min(f2 + wo.z, F32(1e-8));
  const float g2 =
      wi.z * 2.0f * wo.z / clamp_min(f1 * wo.z + f2 * wi.z, F32(1e-8));
  const float ratio = g2 / clamp_min(g1, F32(1e-8));
  const float w_spec = wi.z > 0.0f ? ratio : 0.0f;
  const Vec d_spec = to_world(wi, tg, bt, n);

  // sampling.cosine_hemisphere_p.
  const float cos_theta = sqrtf(u0);
  const float sin_theta =
      sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  const Vec d_diff = to_world(
      {sin_theta * cos_phi, sin_theta * sin_phi, cos_theta}, tg, bt, n);

  // Metals reflect their color; dielectric specular is achromatic,
  // scaled by a Schlick weight.
  const Vec h = normalize({view.x + d_spec.x, view.y + d_spec.y,
                           view.z + d_spec.z});
  const float fres = schlick_weight(dot(d_spec, h));
  const float dielectric = (fres * F32(0.96) + F32(0.04)) * (1.0f - metallic);
  const float one_m = 1.0f - metallic;
  const Vec spec_col = {
      (color.x + (1.0f - color.x) * fres) * metallic + dielectric,
      (color.y + (1.0f - color.y) * fres) * metallic + dielectric,
      (color.z + (1.0f - color.z) * fres) * metallic + dielectric};
  const bool take_spec = usel < p_spec;
  Vec direction = select(take_spec, d_spec, d_diff);
  const float p = take_spec ? clamp_min(p_spec, F32(1e-3))
                            : clamp_min(1.0f - p_spec, F32(1e-3));
  const float inv_p = 1.0f / p;
  Vec weight = scale(take_spec ? scale(spec_col, w_spec)
                               : scale(color, one_m), inv_p);
  if (take_spec && w_spec <= 0.0f) weight = {0.0f, 0.0f, 0.0f};

  // Transmission lobe: a Fresnel-weighted choice between refraction
  // and mirror reflection; total internal reflection always reflects
  // (ops/bounce_kernel._refract_p).
  const float eta = entering ? 1.0f / ior : ior;
  const float cos_i = dot(view, n);
  const float sin2_t = eta * eta * clamp_min(1.0f - cos_i * cos_i, 0.0f);
  const bool tir = sin2_t > 1.0f;
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const float nt = eta * cos_i - cos_t;
  const Vec d_refr = normalize({view.x * -eta + n.x * nt,
                                view.y * -eta + n.y * nt,
                                view.z * -eta + n.z * nt});
  const float q = (1.0f - ior) / (ior + 1.0f);
  const float f0 = q * q;
  const float fr = f0 + (1.0f - f0) * schlick_weight(fabsf(cos_i));
  const float u_t = rand(s);
  const bool reflect_inst = tir || u_t < fr;
  const float km = cos_i * 2.0f;
  const Vec d_mirr = normalize({n.x * km - view.x, n.y * km - view.y,
                                n.z * km - view.z});
  const float u_tsel = rand(s);
  const bool take_trans = transmission > 0.0f && u_tsel < transmission;
  const bool transmitted = take_trans && !reflect_inst;
  if (take_trans) {
    direction = select(reflect_inst, d_mirr, d_refr);
    weight = color;
  }

  // trace_paths: throughput, the offset origin, retirement, roulette.
  Vec thr = {thr_in.x * weight.x, thr_in.y * weight.y, thr_in.z * weight.z};
  const float off = (transmitted ? -1.0f : 1.0f) * a.bounce_offset;
  const Vec o = {wp.x + n.x * off, wp.y + n.y * off, wp.z + n.z * off};
  const float peak = maximum(thr.x, maximum(thr.y, thr.z));
  bool act = active && hit && peak > F32(1e-5);
  if (a.roulette) {
    const float p_cont = clamp(peak, F32(0.05), F32(0.95));
    const float u_rr = rand(s);
    thr = scale(thr, 1.0f / p_cont);
    act = act && u_rr < p_cont;
  }
  if (!act) thr = {0.0f, 0.0f, 0.0f};

  const long long nn = a.n;
  float* out = a.out + i;
  out[0] = o.x;
  out[nn] = o.y;
  out[2 * nn] = o.z;
  out[3 * nn] = direction.x;
  out[4 * nn] = direction.y;
  out[5 * nn] = direction.z;
  out[6 * nn] = thr.x;
  out[7 * nn] = thr.y;
  out[8 * nn] = thr.z;
  a.seed_out[i] = static_cast<long long>(s);
  a.active_out[i] = act ? 1 : 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int hrt_sample_bounce(BounceArgs args, void* stream) {
  if (args.n <= 0) return 0;
  const int blocks = (args.n + kThreads - 1) / kThreads;
  sample_bounce_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
