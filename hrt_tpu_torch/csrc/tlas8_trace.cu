// Two-level BVH8 walk (K4), TLAS -> BLAS: closest hit as a warp packet
// walked nearest child first, any hit as a thread per ray with the
// leaves of a warp tested together.
//
// Replaces the Pallas kernel of hrt_tpu/ops/traversal_tlas8.py
// (`_trace_tiles_tlas8`, body `_make_kernel`).  The TPU kernel walks a
// 1024-ray tile with one SMEM stack, re-bases 8-row groups of the tile
// into an instance's object space in VMEM and restores world space
// lazily.  It reads the unified table of ops/tlas.py: TLAS wide nodes
// below `tlas_nw` (leaf metas instance id + 1), then the BLAS regions
// (leaf metas global pool start + 1).  Both kernels read a wide node as
// one 256-byte record (`TwoLevelFlat.w8_rec`, the table repacked node by
// node: child j of node q at 64 q + 8 j words) instead of eight 32-byte
// records 512 bytes apart, and test triangles with `moller_scaled` (no
// division until a triangle passes).
//
// What bounds it on this card, from the counts (traversal_tlas8.
// visit_counts, PERF.md): on the instanced frame a primary ray visits ~4
// TLAS and ~3 BLAS wide nodes and runs ~62 triangle tests when the
// children are walked in slot order (leaves first), ~36 when the hit
// children are walked nearest first: the closest walk's extra leaves are
// its order's.  A shadow ray's work is the same in either order.  The
// first port (4f0bb03) walked a thread per ray in slot order, ran each
// leaf loop as its lane reached it, and kept a per-ray stack in local
// memory.
//
// Closest (`tlas8_closest_kernel`): the primary rays of a warp are
// coherent, so the warp walks one packet.
// - Each item (a wide node, a BLAS leaf, an instance) carries the mask of
//   the lanes that hit its box; the others wait.  Lanes 0-15 copy a
//   node's 256 bytes into shared memory with one 16-byte load each and
//   every lane slab-tests the 8 child boxes from there.
// - Hit children are ordered by the packet's entry distance (the
//   smallest of its lanes', __reduce_min_sync); the nearest is walked
//   next, the others go on the warp's stack in shared memory, farthest
//   first, each with its box and mask.  Popping an entry tests its box
//   again against each lane's live t, so a lane drops a subtree that its
//   nearer hits have passed.
// - Entering an instance pushes a marker under its BLAS root, so the
//   warp finishes one instance before anything else: its lanes go into
//   object space (one transform load for the warp), and popping the
//   marker brings their world rays back.
// - A leaf's triangles are staged in shared memory 32 at a time and read
//   back by the lanes that hit it as broadcasts.
// Each lane tests the boxes and triangles of a per-ray walk in the
// packet's order, so its hit equals the plain walk's up to equal-t ties.
// The stack holds at most 7 entries per wide level plus the marker.
//
// Any hit (`tlas8_any_hit_kernel`): shadow rays of a warp start on
// different surfaces and walk apart, and a packet serializes the warp
// over the union of their paths (tried: slower than the first port), so
// each thread walks its ray in slot order with a per-ray stack of node
// entries (base << 8 | rank-mask, as K1), instance entries -(inst + 1)
// and, inside an instance, BLAS leaf entries -(pool start + 1).  Leaves
// wait (Aila & Laine's while-while): a lane that pops a leaf parks on
// it, the others step on, and once every live lane is parked or done
// they all test their leaves in one pass.  The first hit retires a ray.
//
// The counting builds (`COUNT`, launched when the wrapper is given a
// count buffer: HRT_DEBUG_COUNTERS) are the same walks writing, per ray,
// the work its lane took part in under traversal_tlas8.COUNTS (TLAS and
// BLAS node visits and the child boxes they test, instances entered,
// leaves entered, triangle tests), and per warp the closest packet's
// items (TLAS nodes, instances, BLAS nodes, leaves, restores) or the any
// hit's loop steps and leaf passes.  The any-hit walk's per-ray counts
// are the plain walk's (traversal_tlas8.visit_counts in the table's
// order).
//
// A ray with t_max < 0 is dead from the start.  The stack sizes come
// from the host's bound (ops/tlas.py `stack_bound`, at most 128),
// templated 64 / 128.  Slab test and instance transform: walk_common.cuh;
// the staging, the entry-distance slab test and the triangle test:
// skip_common.cuh.
#include <cuda_runtime.h>

#include "skip_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// An item or stack entry's target: payload << 2 | kind.
constexpr int kNode = 0, kLeaf = 1, kInst = 2, kMark = 3;
// The counting builds' per-ray rows (traversal_tlas8.COUNTS).
enum { kTlasNodes, kTlasBoxes, kInsts, kBlasNodes, kBlasBoxes, kLeaves,
       kTests, kRayCounts };

// A counting build's rows: kRayCounts per ray (n each), then `nwc` per
// warp.
template <int NWC>
__device__ __forceinline__ void write_counts(int* __restrict__ cnt_out,
                                             int n, int i, int lane,
                                             const int (&c)[kRayCounts],
                                             const int (&w)[NWC]) {
  const int nw = (n + 31) / 32, wi = i / 32;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < kRayCounts; ++k) cnt_out[k * n + i] = c[k];
  }
  if (lane == 0 && wi < nw) {
#pragma unroll
    for (int k = 0; k < NWC; ++k) cnt_out[kRayCounts * n + k * nw + wi] = w[k];
  }
}

template <int STACK, bool COUNT>
__global__ void __launch_bounds__(kThreads)
tlas8_closest_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tmax, int n,
                     const int4* __restrict__ rec,
                     const float4* __restrict__ tris,
                     const float4* __restrict__ tf,
                     const int* __restrict__ roots, int tlas_nw,
                     int leaf_size, float t_min, float* __restrict__ t_out,
                     int* __restrict__ tri_out, int* __restrict__ inst_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ cnt_out) {
  // A stack entry: the child's box words 0-5 and (target, lane mask).
  __shared__ int4 s_stack[kWarps][STACK][2];
  __shared__ int4 s_node[kWarps][16];
  __shared__ float4 s_tris[kWarps][32 * 3];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  int4(*stk)[2] = s_stack[warp];
  int4* sn = s_node[warp];
  float4* st = s_tris[warp];
  // Every lane of the warp takes part in its votes; lanes past n are dead.
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jr = min(i, n - 1);
  const float wox = ox[jr], woy = oy[jr], woz = oz[jr];
  const float wdx = dx[jr], wdy = dy[jr], wdz = dz[jr];
  Ray r;
  hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
  float t = tmax[jr];
  int best = -1, best_inst = -1;
  float bu = 0.0f, bv = 0.0f;
  // Warp-uniform state: the item (from the TLAS root), its lanes, the
  // stack depth and the instance the item's lanes are in.
  int kind = kNode, val = 0;
  unsigned mask = __ballot_sync(kFull, i < n && t >= 0.0f);
  int sp = 0, cur_inst = -1;
  // The counting build's counts: its lane's, and the packet's items
  // (TLAS nodes, instances, BLAS nodes, leaves, restores).
  [[maybe_unused]] int cr[kRayCounts] = {}, cw[5] = {};
  while (true) {
    const bool mine = (mask >> lane) & 1u;
    bool pop = true;
    if (kind == kMark) {  // leave the instance
      if constexpr (COUNT) ++cw[4];
      if (mine) hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
      cur_inst = -1;
    } else if (mask && kind == kInst) {  // enter instance val
      if constexpr (COUNT) {
        ++cw[1];
        cr[kInsts] += mine;
      }
      if (mine) hrt::enter_instance(r, tf, val, wox, woy, woz, wdx, wdy, wdz);
      cur_inst = val;
      if (lane == 0)
        stk[sp][1] = make_int4(0, 0, kMark, static_cast<int>(mask));
      __syncwarp();
      ++sp;
      kind = kNode;
      val = __ldg(roots + cur_inst);
      pop = false;
    } else if (mask && kind == kLeaf) {
      if constexpr (COUNT) {
        ++cw[3];
        cr[kLeaves] += mine;
      }
      for (int k0 = 0; k0 < leaf_size; k0 += 32) {
        const int kn = min(32, leaf_size - k0);
        hrt::stage_tris(st, tris, val + k0, kn, lane);
        if (mine) {
#pragma unroll 4
          for (int k = 0; k < kn; ++k) {
            float th, uh, vh;
            if constexpr (COUNT) ++cr[kTests];
            if (hrt::moller_scaled(st[3 * k], st[3 * k + 1], st[3 * k + 2], r,
                                   t_min, t, th, uh, vh)) {
              best = val + k0 + k;
              best_inst = cur_inst;
              t = th;
              bu = uh;
              bv = vh;
            }
          }
        }
      }
    } else if (mask) {  // visit wide node val
      __syncwarp();  // the last node's reads are done
      if (lane < 16) sn[lane] = __ldg(rec + 16 * val + lane);
      __syncwarp();
      const bool in_tlas = val < tlas_nw;
      if constexpr (COUNT) {
        cw[0] += in_tlas;
        cw[2] += !in_tlas;
        cr[kTlasNodes] += mine && in_tlas;
        cr[kBlasNodes] += mine && !in_tlas;
      }
      const int first_child = sn[1].w;  // slot 0, word 7
      unsigned m[8], key[8];
      int cnt = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int4 a = sn[2 * c], b = sn[2 * c + 1];
        float tn = 0.0f;
        const bool hit =
            b.z != 0 && mine &&
            hrt::slab_entry(__int_as_float(a.x), __int_as_float(a.y),
                            __int_as_float(a.z), __int_as_float(a.w),
                            __int_as_float(b.x), __int_as_float(b.y), r,
                            t_min, t, tn);
        m[c] = __ballot_sync(kFull, hit);
        // t_near >= t_min > 0, so its bits order like the floats.
        key[c] = __reduce_min_sync(kFull,
                                   hit ? __float_as_uint(tn) : 0xffffffffu);
        cnt += m[c] != 0u;
        if constexpr (COUNT) {
          cr[kTlasBoxes] += b.z != 0 && mine && in_tlas;
          cr[kBlasBoxes] += b.z != 0 && mine && !in_tlas;
        }
      }
      if (cnt) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (!m[c]) continue;
          int rank = 0;
#pragma unroll
          for (int o = 0; o < 8; ++o)
            rank += m[o] && (key[o] < key[c] || (key[o] == key[c] && o < c));
          const int4 a = sn[2 * c], b = sn[2 * c + 1];
          const int target =
              b.z < 0 ? ((first_child - b.z - 1) << 2) | kNode
                      : ((b.z - 1) << 2) | (in_tlas ? kInst : kLeaf);
          if (rank == 0) {  // the nearest: walked next
            kind = target & 3;
            val = target >> 2;
            mask = m[c];
          } else if (lane == 0) {  // the farthest deepest on the stack
            const int slot = sp + cnt - 1 - rank;
            stk[slot][0] = a;
            stk[slot][1] = make_int4(b.x, b.y, target, static_cast<int>(m[c]));
          }
        }
        __syncwarp();
        sp += cnt - 1;
        pop = false;
      }
    }
    if (!pop) continue;
    if (sp == 0) break;
    --sp;
    const int4 a = stk[sp][0], b = stk[sp][1];
    kind = b.z & 3;
    val = b.z >> 2;
    mask = static_cast<unsigned>(b.w);
    if (kind != kMark) {  // the box again, against each lane's live t
      float tn;
      mask = __ballot_sync(
          kFull, ((mask >> lane) & 1u) &&
                     hrt::slab_entry(__int_as_float(a.x), __int_as_float(a.y),
                                     __int_as_float(a.z), __int_as_float(a.w),
                                     __int_as_float(b.x), __int_as_float(b.y),
                                     r, t_min, t, tn));
    }
  }
  if constexpr (COUNT) write_counts(cnt_out, n, i, lane, cr, cw);
  if (i >= n) return;
  t_out[i] = t;
  tri_out[i] = best;
  inst_out[i] = best_inst;
  u_out[i] = bu;
  v_out[i] = bv;
}

template <int STACK, bool COUNT>
__global__ void __launch_bounds__(kThreads)
tlas8_any_hit_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const float* __restrict__ tmax, int n,
                     const int4* __restrict__ rec,
                     const float4* __restrict__ tris,
                     const float4* __restrict__ tf,
                     const int* __restrict__ roots, int tlas_nw,
                     int leaf_size, float t_min,
                     unsigned char* __restrict__ occ_out,
                     int* __restrict__ cnt_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  [[maybe_unused]] const int lane = threadIdx.x & 31;
  const int jr = min(i, n - 1);
  const float wox = ox[jr], woy = oy[jr], woz = oz[jr];
  const float wdx = dx[jr], wdy = dy[jr], wdz = dz[jr];
  Ray r;
  hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
  const float t = tmax[jr];
  bool blocked = false;
  bool done = !(i < n && t >= 0.0f);  // t_max < 0 marks a dead ray
  int stack[STACK];
  stack[0] = 1;  // TLAS root: base 0, one internal child of rank 0
  int sp = 1;
  int cur_inst = -1;   // instance whose object space r is in, or -1
  int inst_base = 0;   // stack depth at which it was entered
  int parked = -1;     // pool slot of a hit leaf not tested yet
  // The counting build's counts: its lane's, and the warp's steps and
  // leaf passes.
  [[maybe_unused]] int cr[kRayCounts] = {}, cw[2] = {};
  while (__any_sync(kFull, !done)) {
    if constexpr (COUNT) ++cw[0];
    if (!done && parked < 0) {  // one stack entry
      if (sp == 0) {
        done = true;
      } else {
        const int e = stack[--sp];
        if (cur_inst >= 0 && sp < inst_base) {  // left the instance
          hrt::set_ray(r, wox, woy, woz, wdx, wdy, wdz);
          cur_inst = -1;
        }
        if (e < 0 && cur_inst >= 0) {  // a BLAS leaf: park on it
          parked = -e - 1;
        } else if (e < 0) {  // enter instance -(e + 1)
          cur_inst = -e - 1;
          if constexpr (COUNT) ++cr[kInsts];
          hrt::enter_instance(r, tf, cur_inst, wox, woy, woz, wdx, wdy, wdz);
          inst_base = sp;
          stack[sp++] = (__ldg(roots + cur_inst) << 8) | 1;
        } else {  // visit a node entry's lowest remaining child
          const int mask = e & 255;
          const int base_e = e >> 8;
          const int low = mask & -mask;
          if (mask ^ low) stack[sp++] = (base_e << 8) | (mask ^ low);
          const int node_id = base_e + __ffs(low) - 1;
          const int4* node = rec + 16 * node_id;
          const int first_child = __ldg(node + 1).w;  // slot 0, word 7
          int int_mask = 0, leaf_mask = 0;
          [[maybe_unused]] const bool in_tlas = node_id < tlas_nw;
          if constexpr (COUNT) {
            cr[kTlasNodes] += in_tlas;
            cr[kBlasNodes] += !in_tlas;
          }
          for (int c = 0; c < 8; ++c) {
            const int4 a = __ldg(node + 2 * c), b = __ldg(node + 2 * c + 1);
            if (b.z == 0) break;  // empties are last
            if constexpr (COUNT) {
              cr[kTlasBoxes] += in_tlas;
              cr[kBlasBoxes] += !in_tlas;
            }
            if (!hrt::slab_hit(__int_as_float(a.x), __int_as_float(a.y),
                               __int_as_float(a.z), __int_as_float(a.w),
                               __int_as_float(b.x), __int_as_float(b.y), r,
                               t_min, t))
              continue;
            if (b.z < 0)
              int_mask |= 1 << (-b.z - 1);
            else
              leaf_mask |= 1 << c;
          }
          if (int_mask) stack[sp++] = (first_child << 8) | int_mask;
          // Leaves (TLAS: instances) on top, slot order first off.
          while (leaf_mask) {
            const int c = 31 - __clz(leaf_mask);
            leaf_mask ^= 1 << c;
            stack[sp++] = -__ldg(reinterpret_cast<const int*>(node) + 8 * c +
                                 6);
          }
        }
      }
    }
    // Every live lane parked or done: the parked lanes test their leaves.
    const bool pass = !__any_sync(kFull, !done && parked < 0);
    if constexpr (COUNT) cw[1] += __any_sync(kFull, pass && parked >= 0);
    if (pass && parked >= 0) {
      const float4* tp = tris + 3 * static_cast<size_t>(parked);
      if constexpr (COUNT) ++cr[kLeaves];
      for (int k = 0; k < leaf_size; ++k) {
        float th, uh, vh;
        if constexpr (COUNT) ++cr[kTests];
        if (hrt::moller_scaled(__ldg(tp + 3 * k), __ldg(tp + 3 * k + 1),
                               __ldg(tp + 3 * k + 2), r, t_min, t, th, uh,
                               vh)) {
          blocked = done = true;  // the first hit retires the ray
          break;
        }
      }
      parked = -1;
    }
  }
  if constexpr (COUNT) write_counts(cnt_out, n, i, lane, cr, cw);
  if (i < n) occ_out[i] = blocked ? 1 : 0;
}

template <int STACK>
void launch(bool closest, bool count, int blocks, cudaStream_t s,
            const float* ox, const float* oy, const float* oz,
            const float* dx, const float* dy, const float* dz,
            const float* tmax, int n, const int4* rec, const float4* tris,
            const float4* tf, const int* roots, int tlas_nw, int leaf_size,
            float t_min, float* t_out, int* tri_out, int* inst_out,
            float* u_out, float* v_out, unsigned char* occ_out,
            int* cnt_out) {
  if (closest) {
    auto* kernel = count ? tlas8_closest_kernel<STACK, true>
                         : tlas8_closest_kernel<STACK, false>;
    kernel<<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, tf, roots, tlas_nw,
        leaf_size, t_min, t_out, tri_out, inst_out, u_out, v_out, cnt_out);
  } else {
    auto* kernel = count ? tlas8_any_hit_kernel<STACK, true>
                         : tlas8_any_hit_kernel<STACK, false>;
    kernel<<<blocks, kThreads, 0, s>>>(ox, oy, oz, dx, dy, dz, tmax, n, rec,
                                       tris, tf, roots, tlas_nw, leaf_size,
                                       t_min, occ_out, cnt_out);
  }
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (global pool id, -1 on a
// miss), inst (instance id, -1 on a miss), u and v; any-hit mode writes
// occ (1 where blocked).  The unused outputs may be null.  `records` is
// the unified table as (nodes, 64) int32 node records (node q's 8 child
// records of 8 words at 64 q; 16-byte aligned), `tf` the (I, 12) float32
// obj_from_world rows, `roots` the (I,) BLAS root ids, `stack_size` the
// host's bound (at most 128).  With `cnt_out` (int32, 7 n + 5 ceil(n /
// 32) closest, 7 n + 2 ceil(n / 32) any hit) the counting build runs and
// writes its counts there.  Returns cudaGetLastError() after the launch.
extern "C" int hrt_tlas8_trace(const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* tmax, int n, const int* records,
                               const float* tris, const float* tf,
                               const int* roots, int tlas_nw, int leaf_size,
                               float t_min, int stack_size, int closest,
                               float* t_out, int* tri_out, int* inst_out,
                               float* u_out, float* v_out,
                               unsigned char* occ_out, int* cnt_out,
                               void* stream) {
  if (n <= 0) return 0;
  if (stack_size < 1 || stack_size > 128 || leaf_size < 1)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(records) % 16 != 0 ||
      reinterpret_cast<size_t>(tris) % 16 != 0 ||
      reinterpret_cast<size_t>(tf) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(records);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* tf4 = reinterpret_cast<const float4*>(tf);
  const bool count = cnt_out != nullptr;
  if (stack_size <= 64) {
    launch<64>(closest != 0, count, blocks, s, ox, oy, oz, dx, dy, dz, tmax,
               n, r4, t4, tf4, roots, tlas_nw, leaf_size, t_min, t_out,
               tri_out, inst_out, u_out, v_out, occ_out, cnt_out);
  } else {
    launch<128>(closest != 0, count, blocks, s, ox, oy, oz, dx, dy, dz, tmax,
                n, r4, t4, tf4, roots, tlas_nw, leaf_size, t_min, t_out,
                tri_out, inst_out, u_out, v_out, occ_out, cnt_out);
  }
  return static_cast<int>(cudaGetLastError());
}
