// Binary two-level skip-link walk (K5), TLAS -> BLAS, a thread per ray
// nearest first with the leaves of a warp tested together: closest hit
// and any hit.
//
// Replaces the Pallas kernel of hrt_tpu/ops/tlas.py (`_trace_tiles_tlas`,
// body `_make_tlas_kernel`).  One table holds the TLAS's skip-link rows
// first, then every mesh's BLAS rows with globalized leaf codes and skip
// links (ops/tlas.py `build_two_level_flat`).  The TPU kernel walks a
// tile with one cursor and re-bases the whole tile into an instance's
// object space.  Each ray's own walk is
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
// Here each thread walks its ray over the same tables nearest first: a
// hit internal node tests both children (left i + 1, right the left
// child's skip), walks the nearer and pushes the farther with its entry
// distance; entering an instance pushes a marker under its BLAS root
// and popping the marker brings the world ray back.  Closest mode drops
// a popped entry whose entry distance is past the live t.  So closest
// hits equal the per-ray walk's (traversal_tlas_skip.trace_plain) up to
// equal-t ties and `moller_scaled`'s rounding at edges; occlusion is
// the same set.  traversal_tlas_skip.visit_counts(nearest=True) is the
// plain mirror of this order.
//
// What bounds it on this card: divergent dependent loads, and the rays
// that walk longest.  On the instance forest (33,125 instances of one
// 320-triangle sphere BLAS; traversal_tlas_skip.visit_counts) a primary
// ray makes ~34 TLAS and ~11 BLAS node visits, enters ~2 instances and
// runs ~66 triangle tests in the table's order, ~7% less nearest first
// on the mean; but the longest walks (rays near the horizon) shorten far
// more (PERF.md, chip_smoke.py phase 19), and a 512x384 batch is about
// one wave, so its slowest warps set the time.  The rays of a warp walk
// different paths (different instances, each randomly rotated), so each
// 16-byte load of a node or a triangle is up to 32 addresses, and a lane
// that tests a leaf while the others step makes the warp run that
// leaf's loop alone.  The first port (221599d) walked the table's
// order, ran every leaf loop as its lane reached it and read a node with
// eight 4-byte loads 512 bytes apart.  Here:
// - Nearest first, as above: the longest walks shorten most, and an
//   internal node's two children are read in one step.  The stack is
//   per thread (local memory), one entry per binary level at most: the
//   host's bound (ops/tlas.py `skip_stack_bound`), templated 64 / 128.
// - A node is its 32-byte record (`TwoLevelFlat.skip_rec`,
//   skip_common.cuh layout): two 16-byte loads.
// - Leaves wait (Aila & Laine's while-while): a lane that reaches a BLAS
//   leaf parks on it, the others step on, and once every live lane of
//   the warp is parked or done, all parked lanes run their leaf loops in
//   one pass, testing with `moller_scaled` (no division until a triangle
//   passes).  A parked lane keeps its live t.
// - Any-hit mode retires a ray at its first hit; a ray with t_max < 0 is
//   dead from the start.
// Tried on the card and dropped, each slower than this design (PERF.md):
// a warp-packet walk (K3's design: the lanes at the warp's smallest
// (TLAS leaf, BLAS cursor) key test one node together), which serializes
// the warp over the union of its rays' paths and was slower than the
// first port; the sphere BLAS staged in shared memory per block, which
// the L1 cache already holds; and the table's order with leaves
// waiting.
//
// Slab tests and instance transform: walk_common.cuh and skip_common.cuh;
// the record read and the triangle test: skip_common.cuh (shared with K3
// and K4).
#include <climits>

#include <cuda_runtime.h>

#include "skip_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// An item of the walk: internal node n -> 2n; a leaf or an instance with
// leaf code c -> 2c + 1; kNone: nothing (pop next), or on the stack the
// instance's marker.
constexpr int kNone = INT_MIN;

__device__ __forceinline__ int item(int node, int code) {
  return code == 0 ? 2 * node : 2 * code + 1;
}

template <int STACK, bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
tlas_skip_trace_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax, int n, const int4* __restrict__ rec,
    const float4* __restrict__ tris, const float4* __restrict__ tf,
    const int* __restrict__ blas_base, int leaf_size, float t_min,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    int* __restrict__ inst_out, float* __restrict__ u_out,
    float* __restrict__ v_out, unsigned char* __restrict__ occ_out) {
  // Every lane of the warp takes part in its votes; lanes past n are dead.
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = min(i, n - 1);
  const float wox = ox[j], woy = oy[j], woz = oz[j];
  const float wdx = dx[j], wdy = dy[j], wdz = dz[j];
  Ray r;
  hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
  float t = tmax[j];
  int best = -1, best_inst = -1;
  float bu = 0.0f, bv = 0.0f;
  bool done = !(i < n && t >= 0.0f);  // t_max < 0 marks a dead ray
  int stack[STACK];       // items, far children and instance markers
  float entry[STACK];     // their entry distances
  int sp = 0, cur = kNone, inst = -1;
  int parked = -1;  // pool slot of a reached leaf not tested yet
  if (!done) {  // the TLAS root
    int code, skip;
    if (hrt::skip_rec_test(rec, 0, r, t_min, t, code, skip))
      cur = item(0, code);
    else
      done = true;
  }
  while (__any_sync(kFull, !done)) {
    if (!done && parked < 0) {  // one step of the walk
      if (cur == kNone) {  // pop
        if (sp == 0) {
          done = true;
        } else {
          --sp;
          if (stack[sp] == kNone)  // the instance's marker
            hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
          else if (!CLOSEST || entry[sp] <= t)
            cur = stack[sp];
        }
      } else if (cur & 1) {  // a leaf: park on it; an instance: enter
        const int code = cur >> 1;
        cur = kNone;
        if (code > 0) {
          parked = code - 1;
        } else {
          inst = -code - 1;
          hrt::enter_instance(r, tf, inst, wox, woy, woz, wdx, wdy, wdz);
          stack[sp++] = kNone;
          const int root = __ldg(blas_base + inst);
          int rcode, skip;
          if (hrt::skip_rec_test(rec, root, r, t_min, t, rcode, skip))
            cur = item(root, rcode);
        }
      } else {  // an internal node: both children, the nearer next
        const int left = (cur >> 1) + 1;
        const int4 a0 = __ldg(rec + 2 * left), a1 = __ldg(rec + 2 * left + 1);
        const int right = a1.w;  // the left child's skip
        const int4 b0 = __ldg(rec + 2 * right);
        const int4 b1 = __ldg(rec + 2 * right + 1);
        float tl, tr;
        const bool hl = hrt::slab_entry(
            __int_as_float(a0.x), __int_as_float(a0.y), __int_as_float(a0.z),
            __int_as_float(a0.w), __int_as_float(a1.x), __int_as_float(a1.y),
            r, t_min, t, tl);
        const bool hr = hrt::slab_entry(
            __int_as_float(b0.x), __int_as_float(b0.y), __int_as_float(b0.z),
            __int_as_float(b0.w), __int_as_float(b1.x), __int_as_float(b1.y),
            r, t_min, t, tr);
        const int il = item(left, a1.z), ir = item(right, b1.z);
        if (hl && hr) {
          const bool near_left = tl <= tr;
          stack[sp] = near_left ? ir : il;
          entry[sp] = near_left ? tr : tl;
          ++sp;
          cur = near_left ? il : ir;
        } else {
          cur = hl ? il : (hr ? ir : kNone);
        }
      }
    }
    // Every live lane parked or done: the parked lanes test their leaves.
    if (!__any_sync(kFull, !done && parked < 0) && parked >= 0) {
      const float4* tp = tris + 3 * static_cast<size_t>(parked);
      for (int k = 0; k < leaf_size; ++k) {
        float th, uh, vh;
        if (hrt::moller_scaled(__ldg(tp + 3 * k), __ldg(tp + 3 * k + 1),
                               __ldg(tp + 3 * k + 2), r, t_min, t, th, uh,
                               vh)) {
          best = parked + k;
          best_inst = inst;
          if (!CLOSEST) {  // any hit: the first hit retires the ray
            done = true;
            break;
          }
          t = th;
          bu = uh;
          bv = vh;
        }
      }
      parked = -1;
    }
  }
  if (i >= n) return;
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

template <int STACK>
void launch(bool closest, int blocks, cudaStream_t s, const float* ox,
            const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, const float* tmax, int n,
            const int4* rec, const float4* tris, const float4* tf,
            const int* blas_base, int leaf_size, float t_min, float* t_out,
            int* tri_out, int* inst_out, float* u_out, float* v_out,
            unsigned char* occ_out) {
  if (closest) {
    tlas_skip_trace_kernel<STACK, true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, tf, blas_base, leaf_size,
        t_min, t_out, tri_out, inst_out, u_out, v_out, occ_out);
  } else {
    tlas_skip_trace_kernel<STACK, false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, tf, blas_base, leaf_size,
        t_min, t_out, tri_out, inst_out, u_out, v_out, occ_out);
  }
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (global pool id, -1 on a
// miss), inst (instance id, -1 on a miss), u and v; any-hit mode writes
// occ (1 where blocked).  The unused outputs may be null.  `rec` is the
// two-level table as (rows * 128, 8) int32 node records (TLAS root at 0;
// 16-byte aligned), `tris` the (T, 12) float32 pool, `tf` the (I, 12)
// float32 obj_from_world rows, `blas_base` the (I,) int32 root node of
// each instance's BLAS, `stack_size` the host's bound (at most 128).
// Returns cudaGetLastError() after the launch.
extern "C" int hrt_tlas_skip_trace(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax, int n,
    const int* rec, const float* tris, const float* tf,
    const int* blas_base, int leaf_size, float t_min, int stack_size,
    int closest, float* t_out, int* tri_out, int* inst_out, float* u_out,
    float* v_out, unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (leaf_size < 1 || stack_size < 1 || stack_size > 128)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(rec) % 16 != 0 ||
      reinterpret_cast<size_t>(tris) % 16 != 0 ||
      reinterpret_cast<size_t>(tf) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(rec);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  if (stack_size <= 64) {
    launch<64>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n, r4,
               t4, tf4, blas_base, leaf_size, t_min, t_out, tri_out,
               inst_out, u_out, v_out, occ_out);
  } else {
    launch<128>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n, r4,
                t4, tf4, blas_base, leaf_size, t_min, t_out, tri_out,
                inst_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
