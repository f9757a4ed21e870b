// Two-level BVH8 walk (TLAS -> BLAS), one thread per ray: closest hit
// and any hit.
//
// Replaces the Pallas kernel of hrt_tpu/ops/traversal_tlas8.py
// (`_trace_tiles_tlas8`, body `_make_kernel`).  The TPU kernel walks a
// 1024-ray tile with one SMEM stack, re-bases 8-row groups of the tile
// into an instance's object space in VMEM and restores world space
// lazily.  Here each ray walks alone and keeps everything in registers:
// the world origin and direction, the active-space ray (world, or the
// current instance's object space) with its slab-test terms, and the
// live t.  The stack is per ray (local memory, L1-cached) and holds node
// entries (base << 8 | rank-mask, as K1) and instance entries
// -(inst + 1).
//
// - A node below `tlas_nw` is a TLAS node: its leaf children's metas are
//   instance id + 1.  Its hit internal children go on the stack as one
//   entry, then one instance entry per hit leaf child (slot order), so
//   instances are walked before the TLAS descends.
// - Popping an instance entry enters it: three 16-byte loads of its 3x4
//   obj_from_world rows, the affine transform of the world origin and the
//   linear one of the world direction (unnormalized, so t stays the
//   world-space parameter and closest-hit state never transforms back),
//   the inverse direction with the same 1e-20 clamp as the JAX kernel;
//   the stack depth is remembered and the BLAS root (root << 8 | 1) is
//   pushed.
// - Popping a node entry below that depth leaves the instance: the world
//   ray is set again from registers.
// - BLAS leaves (metas = global pool start + 1) run Möller-Trumbore over
//   their K triangles in object space.  Any-hit mode retires the ray at
//   its first hit; a ray with t_max < 0 is dead and costs nothing.
//
// What bounds it on the card: dependent global loads (node records, then
// triangles, with the instance transform on the path of every BLAS
// entered), divergence between the rays of a warp that are inside an
// instance and those still in the TLAS or in another instance, and the
// per-enter transform plus three reciprocals.  The simple design keeps
// the loads 16 bytes wide through the read-only cache, the record
// decode, slab test, instance transform and Möller-Trumbore shared with
// K1, K3 and K5 (walk_common.cuh), and the rays in pixel order, so the
// threads of a warp mostly enter the same instances.  The stack size is
// a template (32 / 64 / 128 entries),
// picked from the host's bound (ops/tlas.py `stack_bound`), which the
// build refuses past 128.
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;

template <int STACK, bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
tlas8_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tmax, int n,
                   const int* __restrict__ rec,
                   const float4* __restrict__ tris,
                   const float4* __restrict__ tf,
                   const int* __restrict__ roots, int tlas_nw,
                   int leaf_size, float t_min, float* __restrict__ t_out,
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
    int stack[STACK];
    stack[0] = 1;   // TLAS root: base 0, one internal child of rank 0
    int sp = 1;
    int cur_inst = -1;   // instance whose object space r is in, or -1
    int inst_base = 0;   // stack depth at which it was entered
    while (sp > 0) {
      const int e = stack[--sp];
      if (e < 0) {  // enter instance -(e + 1)
        const int inst = -e - 1;
        hrt::enter_instance(r, tf, inst, wox, woy, woz, wdx, wdy, wdz);
        cur_inst = inst;
        inst_base = sp;
        stack[sp++] = (__ldg(roots + inst) << 8) | 1;
        continue;
      }
      if (cur_inst >= 0 && sp < inst_base) {  // left the instance
        hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
        cur_inst = -1;
      }
      const int mask = e & 255;
      const int base_e = e >> 8;
      const int low = mask & -mask;
      const int rem = mask ^ low;
      if (rem) stack[sp++] = (base_e << 8) | rem;
      const int cur = base_e + __ffs(low) - 1;
      const bool in_tlas = cur < tlas_nw;
      const int* node = hrt::node_ptr(rec, cur);
      const int first_child = __ldg(node + 7);
      int int_mask = 0, inst_mask = 0;
      for (int j = 0; j < 8; ++j) {
        bool hit;
        const int meta = hrt::child_test(node, j, r, t_min, t, hit);
        if (meta == 0) break;  // empties are last
        if (!hit) continue;
        if (meta < 0) {
          int_mask |= 1 << (-meta - 1);
          continue;
        }
        if (in_tlas) {
          inst_mask |= 1 << j;
          continue;
        }
        if (hrt::leaf_hits<CLOSEST>(tris, meta - 1, leaf_size, r, t_min, t,
                                    best, bu, bv)) {
          best_inst = cur_inst;
          if (!CLOSEST) goto done;  // any hit: first hit retires the ray
        }
      }
      if (int_mask) stack[sp++] = (first_child << 8) | int_mask;
      while (inst_mask) {
        const int j = __ffs(inst_mask) - 1;
        inst_mask &= inst_mask - 1;
        stack[sp++] = -__ldg(node + j * hrt::kSlotWords + 6);
      }
    }
  }
done:
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
            const int* rec, const float4* tris, const float4* tf,
            const int* roots, int tlas_nw, int leaf_size, float t_min,
            float* t_out, int* tri_out, int* inst_out, float* u_out,
            float* v_out, unsigned char* occ_out) {
  if (closest) {
    tlas8_trace_kernel<STACK, true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, tf, roots, tlas_nw,
        leaf_size, t_min, t_out, tri_out, inst_out, u_out, v_out, occ_out);
  } else {
    tlas8_trace_kernel<STACK, false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, tf, roots, tlas_nw,
        leaf_size, t_min, t_out, tri_out, inst_out, u_out, v_out, occ_out);
  }
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (global pool id, -1 on a
// miss), inst (instance id, -1 on a miss), u and v; any-hit mode writes
// occ (1 where blocked).  The unused outputs may be null.  `tf` is the
// (I, 12) float32 obj_from_world rows, `roots` the (I,) BLAS root ids,
// `stack_size` the host's bound (at most 128).  Returns
// cudaGetLastError() after the launch.
extern "C" int hrt_tlas8_trace(const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* tmax, int n, const int* records,
                               const float* tris, const float* tf,
                               const int* roots, int tlas_nw, int leaf_size,
                               float t_min, int stack_size, int closest,
                               float* t_out, int* tri_out, int* inst_out,
                               float* u_out, float* v_out,
                               unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (stack_size < 1 || stack_size > 128) return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  if (stack_size <= 32) {
    launch<32>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n,
               records, t4, tf4, roots, tlas_nw, leaf_size, t_min, t_out,
               tri_out, inst_out, u_out, v_out, occ_out);
  } else if (stack_size <= 64) {
    launch<64>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n,
               records, t4, tf4, roots, tlas_nw, leaf_size, t_min, t_out,
               tri_out, inst_out, u_out, v_out, occ_out);
  } else {
    launch<128>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n,
                records, t4, tf4, roots, tlas_nw, leaf_size, t_min, t_out,
                tri_out, inst_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
