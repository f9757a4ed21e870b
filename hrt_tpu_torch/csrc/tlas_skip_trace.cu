// Binary two-level skip-link walk (K5), TLAS -> BLAS, one thread per ray:
// closest hit and any hit.
//
// Replaces the Pallas kernel of hrt_tpu/ops/tlas.py (`_trace_tiles_tlas`,
// body `_make_tlas_kernel`).  One table holds the TLAS's skip-link rows
// first, then every mesh's BLAS rows with globalized leaf codes and skip
// links (ops/tlas.py `build_two_level_flat`).  The TPU kernel walks a
// tile with one cursor and re-bases the whole tile into an instance's
// object space; here each ray walks alone, as K3 does, with everything
// in registers: the cursor, the TLAS resume point, the end of the
// current BLAS, the instance it is in, the world ray, the active-space
// ray with its slab-test terms, the live t and the best hit.
//
//   cur = 0; while in_blas or cur < tlas_m:
//     internal node hit   -> cur + 1
//     BLAS leaf hit       -> K tests at pool slot leaf_code - 1, then skip
//     TLAS leaf hit, code -(inst + 1):
//                            enter: the ray into the instance's object
//                            space (3x4 obj_from_world, direction not
//                            normalized, so t stays world), resume =
//                            skip, cur = blas_base[inst], bend =
//                            blas_end[inst]
//     miss                -> skip
//     then, inside a BLAS with cur >= bend: back to the world ray and
//     cur = resume.
//
// Any-hit mode retires the ray at its first hit; a ray with t_max < 0 is
// dead and costs nothing.
//
// What bounds it on this card: what bounds K3 (skip_trace.cu): a chain
// of dependent node loads, eight 4-byte loads 512 bytes apart per node,
// warp threads at different cursors, a fixed left-first order; the
// tables (2.1 MB of TLAS rows for 33,125 instances) stay in L2, so
// latency and not bandwidth is the limit.  Each instance entered adds
// one 48-byte load of its transform, two 4-byte loads of its BLAS range
// and three reciprocals for the object-space inverse direction.  The
// design is K3's (read-only loads, no stack, dead rays leave at once,
// rays in pixel order) and restores the world ray from registers.
//
// Slab test, node reads, instance transform and Möller-Trumbore:
// walk_common.cuh, shared with K1, K3 and K4.
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;

template <bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
tlas_skip_trace_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, const int* __restrict__ nodes,
    const float4* __restrict__ tris, const float4* __restrict__ tf,
    const int* __restrict__ blas_base, const int* __restrict__ blas_end,
    int tlas_m, int leaf_size, float t_min, float* __restrict__ t_out,
    int* __restrict__ tri_out, int* __restrict__ inst_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wox = ox[i], woy = oy[i], woz = oz[i];
  const float wdx = dx[i], wdy = dy[i], wdz = dz[i];
  Ray r;
  hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
  float t = tmax[i];
  int best = -1, best_inst = -1;
  float bu = 0.0f, bv = 0.0f;
  if (t >= 0.0f) {  // t_max < 0 marks a dead ray
    int cur = 0, resume = 0, bend = 0, inst = -1;
    bool in_blas = false;
    while (in_blas || cur < tlas_m) {
      int code, skip;
      const bool hit = hrt::skip_node_test(nodes, cur, r, t_min, t, code,
                                           skip);
      int nxt = skip;
      if (hit && code == 0) {  // internal: descend
        nxt = cur + 1;
      } else if (hit && code > 0) {  // BLAS leaf
        if (hrt::leaf_hits<CLOSEST>(tris, code - 1, leaf_size, r, t_min, t,
                                    best, bu, bv)) {
          best_inst = inst;
          if (!CLOSEST) break;  // any hit: first hit retires the ray
        }
      } else if (hit) {  // TLAS leaf: enter instance -(code + 1)
        inst = -code - 1;
        hrt::enter_instance(r, tf, inst, wox, woy, woz, wdx, wdy, wdz);
        resume = skip;
        nxt = __ldg(blas_base + inst);
        bend = __ldg(blas_end + inst);
        in_blas = true;
      }
      if (in_blas && nxt >= bend) {  // BLAS done: back to the TLAS
        hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
        nxt = resume;
        in_blas = false;
      }
      cur = nxt;
    }
  }
  if (CLOSEST) {
    t_out[i] = t;
    tri_out[i] = best;
    inst_out[i] = best_inst;
    u_out[i] = bu;
    v_out[i] = bv;
  } else {
    occ_out[i] = best >= 0 ? 1 : 0;
  }
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (global pool id, -1 on a
// miss), inst (instance id, -1 on a miss), u and v; any-hit mode writes
// occ (1 where blocked).  The unused outputs may be null.  `nodes` is the
// two-level (R, 8, 128) skip-link table (TLAS rows first, `tlas_m` TLAS
// nodes), `tris` the (T, 12) float32 pool, `tf` the (I, 12) float32
// obj_from_world rows, `blas_base` / `blas_end` the (I,) int32 node range
// of each instance's BLAS.  Returns cudaGetLastError() after the launch.
extern "C" int hrt_tlas_skip_trace(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, int n,
    const float* nodes, const float* tris, const float* tf,
    const int* blas_base, const int* blas_end, int tlas_m, int leaf_size,
    float t_min, int closest, float* t_out, int* tri_out, int* inst_out,
    float* u_out, float* v_out, unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (tlas_m < 1 || leaf_size < 1) return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nd = reinterpret_cast<const int*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  if (closest) {
    tlas_skip_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, nd, t4, tf4, blas_base, blas_end,
        tlas_m, leaf_size, t_min, t_out, tri_out, inst_out, u_out, v_out,
        occ_out);
  } else {
    tlas_skip_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, nd, t4, tf4, blas_base, blas_end,
        tlas_m, leaf_size, t_min, t_out, tri_out, inst_out, u_out, v_out,
        occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
