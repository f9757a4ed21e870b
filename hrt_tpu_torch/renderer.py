"""The path-traced frame: raygen (jittered per frame) -> closest hit ->
attribute gather (base color times its texture) + sky -> next-event
estimation: the Disney BRDF (K2) or the pbr BSDF + shadow any-hit, over
every light or over `light_samples` lights picked by the flat CDF scan
or the light tree -> bounce sampling and Russian roulette -> the next
depth's closest hit, and so on to `max_depth`, with the wavefront
optionally sorted by a 6-D Morton key between depths (`sort_bounces`).

The accel is either a single-level Accel (ops/lbvh.py), traced by K1
when it has a BVH8 table and by K3 when it has not (an LBVH, or a SAH
tree past MAX_WIDE_NODES), or a two-level TwoLevelFlat (ops/tlas.py),
traced by K4 (BVH8 route) or K5 (binary route) and shaded through the
hit instance's normal matrix and material.  Every depth's closest and
shadow traces go to the accel's walk, every depth's Disney BRDF to K2
(the pbr BSDF, as in the JAX package, stays plain PyTorch), every
depth's bounce sampling and roulette to K7 (ops/bounce_kernel.py).
With no accel, or `traversal="bruteforce"` on a single-level scene,
every trace tests every triangle (ops/intersect.py, plain PyTorch as in
the JAX package) in ray blocks, and hits shade from the scene's
attribute table in original ids.

hrt_tpu/renderer.py's `trace_paths` and `render_rows` in plain PyTorch
around the kernels.  Per-pixel output is the JAX package's: the same
RNG words (ops/rng.py) drawn in the same order (the light samples'
before the bounce's), the same samplers (ops/sampling.py,
ops/lightbvh.py).  Only the ray order differs: rays stay in pixel order
(the TPU's pixel-block reorder and shadow interleave are layouts for its
packet tiles), the shadow batch is light-major concatenated, the sorted
wavefront is one stable torch.sort and index gathers instead of a
multi-operand sort, and the k frames of `render_frames` are a Python
loop (raygen computed once when there is no jitter), captured on the
card as one CUDA graph (graphs.py), the counterpart of the JAX
package's jit of a scan.

Every entry point takes `plain=False`; `plain=True` routes the walks,
the BRDF and the bounce to their plain PyTorch versions on whatever
device the tensors are on, which is how a reference frame is rendered
on the card.
`trace_paths` and `render_rows` also return the first hit's G-buffer
when asked (`want_gbuffer`), for the post stages (ops/denoise.py,
models/upscaler.py).

The JAX module's dispatches keep their names and argument order:
`trace_closest_p` / `trace_any_p`, through which every trace of the
frame goes, their (N, 3)-array forms `trace_closest` / `trace_any`,
`interpolate_hit`, and `render_frame`, one frame of `render_frames`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import graphs
from .config import RenderConfig, require_slice, resolve_device
from .models.camera import Camera, CameraArrays, primary_rays_from_px_p
from .models.lights import process_light, process_light_one
from .models.materials import BASE_COLOR_TEX, MatP
from .models.scene import Scene, SceneData
from .models.sky import eval_sky_p
from .models.textures import sample_texture_p
from .ops import (bounce_kernel, intersect, lbvh, lightbvh, math3d, pbr, rng,
                  shade_kernel, tlas, traversal, v3, wavefront)
from .ops.intersect import INF
from .ops.lbvh import ATTR_MAT, Accel
from .ops.tlas import TwoLevelFlat
from .ops.v3 import V3
from .utils import tracing

# Sorted depths of a `sort_bounces` frame: depths 1..SORT_CAP are sorted
# (the JAX package's default cap; Russian roulette has retired most rays
# by depth 3).
SORT_CAP = 2
# The key of a retired ray: after every live key (live keys are shifted
# right one bit).
_DEAD_KEY = 0xFFFFFFFF
# light_sampler="auto" samples lights by the light tree past this many
# lights, by the flat CDF scan up to it (the JAX package's crossover).
AUTO_TREE_LIGHTS = 384
# Rays a block of the brute-force walk, which bounds its (rays x
# tri_chunk) intersection temporaries: the JAX package's largest ray
# block.  The last block may be ragged (a Python loop needs no equal
# blocks); no ray's result depends on its block.
BRUTE_BLOCK = 65536


def camera_arrays(cam: Camera, config: RenderConfig, device) -> CameraArrays:
    return cam.ray_params(config.width, config.height, device)


def _brute_force(config: RenderConfig, accel) -> bool:
    """Whether traces test every triangle: with no accel, or with
    traversal="bruteforce" on a single-level one (a two-level accel is
    always walked, as in the JAX package)."""
    return accel is None or (config.traversal == "bruteforce"
                             and not isinstance(accel, TwoLevelFlat))


def _brute_blocks(scene: SceneData, o: V3, d: V3, t_min, t_max,
                  config: RenderConfig, closest: bool):
    """The brute-force walk over BRUTE_BLOCK-ray blocks, the triangles
    `min(tri_chunk, T)` at a time: (t, tri (original id), u, v) of the
    closest hits within (t_min, t_max), or the occlusion mask."""
    ro, rd = o.to_array(), d.to_array()
    n = ro.shape[0]
    tmax = intersect.ray_t_max(t_max, n, ro.device)
    walk = (intersect.closest_hit_bruteforce if closest
            else intersect.any_hit_bruteforce)
    chunk = min(config.tri_chunk, scene.num_triangles)
    outs = [walk(ro[s:s + BRUTE_BLOCK], rd[s:s + BRUTE_BLOCK],
                 scene.tri_v0, scene.tri_e1, scene.tri_e2, t_min,
                 tmax[s:s + BRUTE_BLOCK], chunk=chunk)
            for s in range(0, n, BRUTE_BLOCK)]
    if closest:
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def trace_closest_p(scene: SceneData, accel, o: V3, d: V3, t_min, t_max,
                    config: RenderConfig, sorted_ids: bool = False,
                    plain: bool = False):
    """Closest hits within (t_min, t_max) of V3 rays, routed as every
    trace of the frame: a TwoLevelFlat to its walk (K4 or K5:
    tlas.closest_hit_tlas, returning (t, tri, inst, u, v) with global
    pool ids); brute force with no accel or traversal="bruteforce"
    ((t, tri, u, v), original ids whatever `sorted_ids`); else the
    accel's walk (K1 or K3: traversal.closest_hit_bvh_p, leaf-pool ids
    with `sorted_ids`, else original ids).  `plain=True` runs the walks'
    plain versions on any device."""
    if isinstance(accel, TwoLevelFlat):
        return tlas.closest_hit_tlas(accel, o, d, t_min, t_max, plain=plain)
    if _brute_force(config, accel):
        return _brute_blocks(scene, o, d, t_min, t_max, config, True)
    return traversal.closest_hit_bvh_p(scene, accel, o, d, t_min, t_max,
                                       sorted_ids=sorted_ids, plain=plain)


def trace_closest(scene: SceneData, accel, o, d, t_min, t_max,
                  config: RenderConfig, sorted_ids: bool = False,
                  plain: bool = False):
    """trace_closest_p on (N, 3) rays."""
    return trace_closest_p(scene, accel, V3.from_array(o), V3.from_array(d),
                           t_min, t_max, config, sorted_ids=sorted_ids,
                           plain=plain)


def trace_any_p(scene: SceneData, accel, o: V3, d: V3, t_min, t_max,
                config: RenderConfig, plain: bool = False) -> torch.Tensor:
    """Occlusion of V3 rays' segments (t_min, t_max), bool (N,), routed
    as trace_closest_p routes: a TwoLevelFlat's walk (K4 or K5), brute
    force, else the accel's walk (K1 or K3)."""
    if isinstance(accel, TwoLevelFlat):
        return tlas.any_hit_tlas(accel, o, d, t_min, t_max, plain=plain)
    if _brute_force(config, accel):
        return _brute_blocks(scene, o, d, t_min, t_max, config, False)
    return traversal.any_hit_bvh_p(scene, accel, o, d, t_min, t_max,
                                   plain=plain)


def trace_any(scene: SceneData, accel, o, d, t_min, t_max,
              config: RenderConfig, plain: bool = False) -> torch.Tensor:
    """trace_any_p on (N, 3) rays."""
    return trace_any_p(scene, accel, V3.from_array(o), V3.from_array(d),
                       t_min, t_max, config, plain=plain)


def interpolate_hit(scene: SceneData, tri_idx, u, v):
    """The hits' unit interpolated normal (N, 3), uv (N, 2) and material
    id (N,) int32, by original triangle id, from one gather of the
    scene's packed (T, 16) attribute rows."""
    attr = torch.cat([scene.nrm0, scene.nrm1, scene.nrm2, scene.uv0,
                      scene.uv1, scene.uv2,
                      scene.tri_mat[:, None].to(torch.float32)], dim=1)
    rows = attr[tri_idx.clamp(min=0).long()]
    w = (1.0 - u - v)[..., None]
    wu, wv = u[..., None], v[..., None]
    normal = w * rows[:, 0:3] + wu * rows[:, 3:6] + wv * rows[:, 6:9]
    uv = w * rows[:, 9:11] + wu * rows[:, 11:13] + wv * rows[:, 13:15]
    return math3d.normalize(normal), uv, rows[:, 15].to(torch.int32)


def _scene_attr_table(scene: SceneData) -> torch.Tensor:
    """The hit-attribute table in original triangle order, with
    Accel.attr's columns (the brute-force walk's ids index it)."""
    return lbvh.hit_attr_table(scene, torch.arange(
        scene.num_triangles, device=scene.tri_v0.device))


def _zero3(like) -> V3:
    z = torch.zeros_like(like)
    return V3(z, z, z)


def _shade_attrs_p(tab: torch.Tensor, tri_idx, u, v):
    """Hit attributes from one gather of the (T, 16 + MAT_W) table by
    leaf-pool id.  Returns (unit normal V3, MatP, the material rows
    (N, MAT_W), the interpolated hit UVs (tu, tv))."""
    rows = tab[tri_idx.clamp(min=0).long()]
    rt = rows.T                                      # (W, N)
    w = 1.0 - u - v
    normal = v3.normalize(V3(
        w * rt[0] + u * rt[3] + v * rt[6],
        w * rt[1] + u * rt[4] + v * rt[7],
        w * rt[2] + u * rt[5] + v * rt[8]))
    tu = w * rt[9] + u * rt[11] + v * rt[13]
    tv = w * rt[10] + u * rt[12] + v * rt[14]
    return (normal, MatP.from_rows_t(rt, base=ATTR_MAT), rows[:, ATTR_MAT:],
            (tu, tv))


class LightBatch(NamedTuple):
    """Next-event terms of C light samples, light-major over (C*N,): the
    direction to the light `l`, `relevant` (BRDF can be nonzero, light
    above threshold, ray hit a surface), the shadow segment's `t_max`
    (-1 on irrelevant lanes), the shadow origins, and per sample its
    color and intensity.  One sample per light (C = L), or, sampled,
    `inv_pdf` and the picked light ids `pick` per sample (C =
    light_samples)."""

    l: V3
    relevant: torch.Tensor
    t_max: torch.Tensor
    origin: V3
    color: list
    intensity: list
    inv_pdf: list | None = None
    pick: list | None = None


def _segments(n: V3, world_pos: V3, config: RenderConfig, per):
    """The light-major batch of `per`: one (l unit, ldir, lcol, lint,
    unbounded, relevant, inv_pdf, pick) tuple per sample.  Shadow rays
    leave the offset surface point, toward the light's distance or,
    from a directional light, unbounded."""
    shadow_o = world_pos + n * config.normal_offset
    sts = [torch.where(rel, torch.where(unb, INF, v3.length(ldir)), -1.0)
           for _, ldir, _, _, unb, rel, _, _ in per]
    sampled = per[0][6] is not None
    return LightBatch(
        l=V3(*(torch.cat([p[0][c] for p in per]) for c in range(3))),
        relevant=torch.cat([p[5] for p in per]), t_max=torch.cat(sts),
        origin=shadow_o.map(lambda a: a.repeat(len(per))),
        color=[p[2] for p in per], intensity=[p[3] for p in per],
        inv_pdf=[p[6] for p in per] if sampled else None,
        pick=[p[7] for p in per] if sampled else None)


def light_batch(scene: SceneData, n: V3, world_pos: V3,
                config: RenderConfig, ray_mask=None) -> LightBatch:
    """One shadow ray per light (ref: calculateColor,
    shaders/raytracing.slang:72-88), concatenated light-major."""
    per = []
    for i in range(scene.lights.shape[0]):
        ldir, lcol, lint, unb = process_light_one(scene.lights[i],
                                                  world_pos)
        l = v3.normalize(ldir)
        relevant = (v3.dot(n, l) > 0.0) & (lint >= config.light_threshold)
        if ray_mask is not None:
            relevant = relevant & ray_mask
        per.append((l, ldir, lcol, lint, unb, relevant, None, None))
    return _segments(n, world_pos, config, per)


def _tree_samples(scene: SceneData, n: V3, world_pos: V3,
                  config: RenderConfig, ray_mask, seed):
    """`light_samples` lights per ray by the light tree's descent
    (ops/lightbvh.py), each weighted by its exact pdf."""
    tree = (scene.light_tree if scene.light_tree is not None
            else lightbvh.build_light_tree(scene.lights))
    per = []
    for _ in range(config.light_samples):
        u, seed = rng.rand(seed)
        pick, pdf = lightbvh.sample_light(tree, world_pos, u)
        ldir, lcol, lint, unb = lightbvh.process_light_rows(
            scene.lights[pick.long()], world_pos)
        l = v3.normalize(ldir)
        relevant = ((v3.dot(n, l) > 0.0) & (lint >= config.light_threshold)
                    & (pdf > 1e-12))
        if ray_mask is not None:
            relevant = relevant & ray_mask
        inv_pdf = 1.0 / torch.clamp(pdf, min=1e-9)
        per.append((l, ldir, lcol, lint, unb, relevant, inv_pdf, pick))
    return per, seed


def _scan_samples(scene: SceneData, n: V3, world_pos: V3,
                  config: RenderConfig, ray_mask, seed):
    """`light_samples` lights per ray in proportion to their unshadowed
    contribution (intensity x NdotL x (luminance + 1e-3)): every light's
    weight at every ray as one (L, N) array, its cumsum over the lights
    as the CDF, and a pick per sample by counting the CDF's entries
    below u x total."""
    lights = scene.lights
    ldir_a, lcol_a, lint_a, unb_a = process_light(lights,
                                                  world_pos.to_array())
    ldx, ldy, ldz = ldir_a[..., 0].T, ldir_a[..., 1].T, ldir_a[..., 2].T
    lint_ln = lint_a.T                                    # (L, N)
    inv_len = torch.rsqrt(torch.clamp(ldx * ldx + ldy * ldy + ldz * ldz,
                                      min=1e-24))
    lx, ly, lz = ldx * inv_len, ldy * inv_len, ldz * inv_len
    ndotl = torch.clamp(n.x[None] * lx + n.y[None] * ly + n.z[None] * lz,
                        min=0.0)
    lum = (0.2126 * lcol_a[:, 0] + 0.7152 * lcol_a[:, 1]
           + 0.0722 * lcol_a[:, 2])
    ws = ndotl * lint_ln * (lum[:, None] + 1e-3)
    ws = torch.where(lint_ln >= config.light_threshold, ws, 0.0) + 1e-12
    cdf = torch.cumsum(ws, dim=0)
    total = cdf[-1]
    per = []
    for _ in range(config.light_samples):
        u, seed = rng.rand(seed)
        pick = torch.sum(cdf[:-1] < (u * total)[None], dim=0)   # (N,)
        at = pick[None]
        sel = lambda a, at=at: a.gather(0, at)[0]
        w_pick = sel(ws)
        relevant = w_pick > 1e-9
        if ray_mask is not None:
            relevant = relevant & ray_mask
        inv_pdf = 1.0 / torch.clamp(w_pick / total, min=1e-9)
        per.append((V3(sel(lx), sel(ly), sel(lz)),
                    V3(sel(ldx), sel(ldy), sel(ldz)),
                    V3(*(lcol_a[pick, c] for c in range(3))), sel(lint_ln),
                    unb_a[pick], relevant, inv_pdf, pick.to(torch.int32)))
    return per, seed


def nee_light_batch(scene: SceneData, n: V3, world_pos: V3,
                    config: RenderConfig, ray_mask=None, seed=None):
    """The light batch of direct_lighting_p, and the seed after its
    draws: sampled (`light_samples` lights per ray, by the light tree
    with light_sampler="bvh" or "auto" past AUTO_TREE_LIGHTS lights,
    else by the flat CDF scan) when light_samples > 0, a seed is given
    and there are more lights than samples, as the JAX package decides;
    otherwise one sample per light."""
    num_lights = scene.lights.shape[0]
    if not (config.light_samples and seed is not None
            and num_lights > config.light_samples):
        return light_batch(scene, n, world_pos, config, ray_mask), seed
    tree = (config.light_sampler == "bvh"
            or (config.light_sampler == "auto"
                and num_lights > AUTO_TREE_LIGHTS))
    per, seed = (_tree_samples if tree else _scan_samples)(
        scene, n, world_pos, config, ray_mask, seed)
    return _segments(n, world_pos, config, per), seed


def _brdf_lm(config: RenderConfig, mat: MatP, rows, n: V3, view: V3,
             lb: LightBatch, plain: bool) -> V3:
    """The BRDF of every sample of the light-major batch: the Disney
    BRDF in one K2 call (its plain version with `plain`), or with
    brdf='pbr' the pbr BSDF in plain PyTorch on the material rows, a
    sample at a time (as the JAX package, it reads the gathered rows,
    not the texture-modulated color)."""
    count = len(lb.color)
    if config.brdf == "pbr":
        nr = n.x.shape[0]
        na, va, la = n.to_array(), view.to_array(), lb.l.to_array()
        f = torch.cat([pbr.bsdf_evaluate_simple(
            rows, na, va, la[i * nr:(i + 1) * nr]) for i in range(count)])
        return V3(f[:, 0], f[:, 1], f[:, 2])
    brdf = (shade_kernel.brdf_light_major_plain if plain
            else shade_kernel.brdf_light_major)
    return brdf(mat, n, view, lb.l, lb.relevant, count)


def direct_lighting_p(scene: SceneData, accel, mat: MatP, rows, n: V3,
                      view: V3, world_pos: V3, config: RenderConfig,
                      ray_mask=None, seed=None, plain: bool = False):
    """Direct light at the hit points over nee_light_batch's samples:
    their BRDF in one call (K2, or the pbr BSDF), all their shadow rays
    in one light-major any-hit call (the accel's walk: K1 or K3, K4 or
    K5 for a two-level accel; or brute force).  A sampled batch weighs
    each sample by its 1 / pdf and averages them.  `rows` are the hits'
    material rows (the pbr BSDF's input).  Returns (radiance V3, the
    advanced seed)."""
    if scene.lights.shape[0] == 0:
        return _zero3(n.x), seed
    lb, seed = nee_light_batch(scene, n, world_pos, config, ray_mask, seed)
    f_lm = _brdf_lm(config, mat, rows, n, view, lb, plain)
    occluded = trace_any_p(scene, accel, lb.origin, lb.l, config.t_min,
                           lb.t_max, config, plain=plain)
    nr = n.x.shape[0]
    out = _zero3(n.x)
    for i in range(len(lb.color)):
        sl = slice(i * nr, (i + 1) * nr)
        vis = 1.0 - occluded[sl].to(torch.float32)
        f = f_lm.map(lambda a: a[sl]) * lb.color[i]
        if lb.inv_pdf is None:
            contrib = f * lb.intensity[i] * vis
        else:
            contrib = f * (lb.intensity[i] * vis * lb.inv_pdf[i])
        out = out + v3.where(lb.relevant[sl], contrib, 0.0)
    if lb.inv_pdf is not None:
        out = out * (1.0 / len(lb.color))
    return out, seed


class SurfaceHits(NamedTuple):
    """Closest hits of a ray batch and their shading inputs."""

    t: torch.Tensor
    hit: torch.Tensor
    normal: V3          # unit, facing the viewer
    mat: MatP           # base color modulated by the texture
    world_pos: V3
    view: V3
    entering: torch.Tensor  # the front face was hit (before the flip)
    rows: torch.Tensor  # the material rows (N, MAT_W), unmodulated


def surface_hits(scene: SceneData, accel, o: V3, d: V3,
                 config: RenderConfig, t_max=INF,
                 plain: bool = False) -> SurfaceHits:
    """Closest hit within (t_min, t_max) and the attribute gather: by
    leaf-pool id from the Accel's table (K1 or K3), by global pool id
    and instance from the TwoLevelFlat (K4 or K5), or, brute force, by
    original id from _scene_attr_table.  In a textured scene
    the base color is multiplied by the hit material's texture at the
    hit's UV (1 where the material has none)."""
    hits = trace_closest_p(scene, accel, o, d, config.t_min, t_max, config,
                           sorted_ids=True, plain=plain)
    if isinstance(accel, TwoLevelFlat):
        t, tri, inst, u, v = hits
        nrm, mat, rows, (tu, tv) = tlas.shade_attrs_tlas(
            accel, scene.materials, tri, inst, u, v)
    else:
        t, tri, u, v = hits
        tab = (_scene_attr_table(scene) if _brute_force(config, accel)
               else accel.attr)
        nrm, mat, rows, (tu, tv) = _shade_attrs_p(tab, tri, u, v)
    if scene.textures is not None and scene.textures.shape[0] > 0:
        tex = sample_texture_p(scene.textures,
                               rows[:, BASE_COLOR_TEX].to(torch.int32),
                               tu, tv)
        mat = mat._replace(color=mat.color * V3(*tex))
    view = -d
    entering = v3.dot(nrm, view) >= 0.0
    nrm = v3.where(entering, nrm, -nrm)
    return SurfaceHits(t, tri >= 0, nrm, mat, o + d * t, view, entering,
                       rows)


def _gbuffer(sh: SurfaceHits) -> dict:
    """The first hit's G-buffer, (N, ·) per field: `normal` (facing the
    viewer, 0 on a miss), `depth` (t, 0 on a miss), `albedo` (the base
    color, 1 on a miss), `world_pos` (0 on a miss) and `hit` (1.0 or
    0.0)."""
    hit = sh.hit
    zero = _zero3(sh.t)
    one = torch.ones_like(sh.t)
    return {
        "normal": v3.where(hit, sh.normal, zero).to_array(),
        "depth": torch.where(hit, sh.t, 0.0),
        "albedo": v3.where(hit, sh.mat.color, V3(one, one, one)).to_array(),
        "world_pos": v3.where(hit, sh.world_pos, zero).to_array(),
        "hit": hit.to(torch.float32),
    }


def _empty_gbuffer(n: int, device) -> dict:
    zeros = lambda *s: torch.zeros((n, *s), device=device)
    return {"normal": zeros(3), "depth": zeros(), "albedo": zeros(3) + 1.0,
            "world_pos": zeros(3), "hit": zeros()}


def trace_paths(scene: SceneData, accel, o: V3, d: V3, seeds,
                config: RenderConfig, plain: bool = False,
                want_gbuffer: bool = False, _batches=None):
    """Radiance of a ray batch over up to `config.max_depth` depths, as
    the JAX package's trace_paths: sky on a miss, direct light plus
    emission on a hit, weighted by the path's throughput; with
    `config.indirect` each hit samples a bounce and the path goes on
    (Russian roulette from `rr_start_depth`), a retired ray tracing
    with t_max = -1 so the walks drop it at once.  `seeds` are the
    rays' RNG words (ops/rng.py).  With `want_gbuffer`, returns
    (radiance, _gbuffer(depth 0's hits)).

    With `config.sort_bounces`, depths 1..SORT_CAP sort the wavefront
    (origins, directions, seeds, throughput, radiance) by
    wavefront.bounce_sort_key_p, retired rays last, and the radiance is
    put back in pixel order by the carried pixel index at the end;
    depth 0's radiance stays in pixel order.

    `_batches`, a list, receives each depth's closest-hit batch, its
    shading inputs, the throughput and the rays active on entry (a dict
    per depth; for measurements and tests).

    Inside a traced frame (utils/tracing.frame) each depth k marks the
    stage clocks `hit.d<k>` (the sort, the closest walk and the
    attribute gather), `nee.d<k>` (sky, the light batch, K2, the shadow
    walk, emission) and `bounce.d<k>` (K7: the bounce, roulette,
    retirement), and counts its live rays on entry as `live.d<k>`."""
    require_slice(config)
    if accel is not None and not isinstance(accel, (Accel, TwoLevelFlat)):
        raise TypeError(f"accel must be an Accel, a TwoLevelFlat or None "
                        f"(brute force), not {type(accel).__name__}")
    n = o.x.shape[0]
    dev = o.x.device
    radiance = _zero3(o.x)
    one = torch.ones_like(o.x)
    throughput = V3(one, one, one)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    seed = seeds
    gbuffer = None
    orig = None         # pixel index of each ray once sorted
    rad_px = None       # depth 0's radiance, in pixel order
    for depth in range(config.max_depth):
        tracing.mark(f"hit.d{depth}")
        tracing.count(f"live.d{depth}", active)
        if config.sort_bounces and 0 < depth <= SORT_CAP:
            key = torch.where(active, wavefront.bounce_sort_key_p(o, d) >> 1,
                              _DEAD_KEY)
            key, perm = torch.sort(key, stable=True)
            take = lambda a: a[perm]
            orig = perm if orig is None else orig[perm]
            if rad_px is None:
                rad_px, radiance = radiance, _zero3(o.x)
            else:
                radiance = radiance.map(take)
            o, d, throughput = o.map(take), d.map(take), throughput.map(take)
            seed = seed[perm]
            active = key != _DEAD_KEY
        t_max = INF if depth == 0 else torch.where(active, INF, -1.0)
        sh = surface_hits(scene, accel, o, d, config, t_max=t_max,
                          plain=plain)
        hit = sh.hit & active
        if _batches is not None:
            _batches.append({"depth": depth, "o": o, "d": d, "t_max": t_max,
                             "hits": sh._replace(hit=hit), "seed": seed,
                             "active": active, "throughput": throughput})

        tracing.mark(f"nee.d{depth}")
        sky_rad = eval_sky_p(scene.sky, d, enabled=config.sky)
        radiance = radiance + v3.where(active & ~sh.hit,
                                       throughput * sky_rad, 0.0)
        direct, seed = direct_lighting_p(
            scene, accel, sh.mat, sh.rows, sh.normal, sh.view, sh.world_pos,
            config, ray_mask=hit, seed=seed, plain=plain)
        emissive = sh.mat.emissive * sh.mat.emission_strength
        radiance = radiance + v3.where(hit, throughput * (direct + emissive),
                                       0.0)
        if want_gbuffer and depth == 0:
            gbuffer = _gbuffer(sh)

        if not config.indirect or depth + 1 == config.max_depth:
            break

        tracing.mark(f"bounce.d{depth}")
        bounce = (bounce_kernel.sample_bounce_plain if plain
                  else bounce_kernel.sample_bounce)
        o, d, throughput, seed, active = bounce(
            sh.mat, sh.normal, sh.view, sh.world_pos, throughput, seed,
            sh.entering, hit, active, config.bounce_offset,
            config.russian_roulette and depth + 1 >= config.rr_start_depth)

    if orig is not None:
        # Back to pixel order: ray i of the sorted wavefront is pixel
        # orig[i].
        radiance = radiance.map(
            lambda a: torch.empty_like(a).index_copy_(0, orig, a)) + rad_px
    if want_gbuffer:
        return radiance, (gbuffer if gbuffer is not None
                          else _empty_gbuffer(n, dev))
    return radiance


def pixel_planes(rows: int, y0: int, config: RenderConfig, device):
    """int64 pixel coordinates (px, py) of rows [y0, y0 + rows), in
    pixel order."""
    w = config.width
    px = torch.arange(w, device=device)[None, :].expand(rows, w).reshape(-1)
    py = (torch.arange(rows, device=device) + y0)[:, None] \
        .expand(rows, w).reshape(-1)
    return px, py


def _rays_at(cam: CameraArrays, config: RenderConfig, pxf, pyf):
    return primary_rays_from_px_p(cam.origin, cam.basis, cam.tan_half_fovy,
                                  cam.aspect, config.width, config.height,
                                  pxf, pyf)


def primary_rays(cam: CameraArrays, rows: int, y0: int,
                 config: RenderConfig):
    """Unjittered camera rays of rows [y0, y0 + rows) in pixel order,
    through the pixels' integer corners (as the JAX package's unjittered
    raygen)."""
    px, py = pixel_planes(rows, y0, config, cam.origin.device)
    return _rays_at(cam, config, px.to(torch.float32), py.to(torch.float32))


def _primary_setup(cam: CameraArrays, rows: int, y0: int,
                   config: RenderConfig):
    """What of a band's primary rays does not depend on the frame: the
    pixel planes, and the rays themselves when there is no jitter."""
    px, py = pixel_planes(rows, y0, config, cam.origin.device)
    rays = None if config.jitter else _rays_at(
        cam, config, px.to(torch.float32), py.to(torch.float32))
    return px, py, rays


def render_rows(scene: SceneData, accel, cam: CameraArrays,
                y0: int, rows: int, config: RenderConfig,
                plain: bool = False, want_gbuffer: bool = False,
                frame=0, _pre=None, _batches=None):
    """Render rows [y0, y0 + rows) of frame `frame` (an int or a 0-d
    integer tensor on the card, rng.as_frame) -> (rows, W, 3) linear
    radiance, and with `want_gbuffer` also the first sample's G-buffer,
    each field (rows, W, ·) in pixel order.  Sample s of a pixel starts
    from pixel_seed(px, py, frame) + s * 0x9E3779B9; with
    `config.jitter` its first two draws offset the ray within the pixel,
    except on frame 0, which shoots through the pixel centre (a
    `where` over the frame on the device, as the JAX package's; the
    unjittered path shoots through the integer corner, as the JAX
    package does).  _pre: render_frames' _primary_setup; _batches: see
    trace_paths.  In a traced frame each sample starts with the stage
    clock `raygen` (utils/tracing.mark)."""
    tracing.mark("raygen")
    px, py, rays = _pre if _pre is not None else _primary_setup(
        cam, rows, y0, config)
    frame = rng.as_frame(frame, px.device)
    seeds = rng.pixel_seed(px, py, frame)
    acc = None
    gbuffer = None
    for s in range(config.spp):
        if s:
            tracing.mark("raygen")
        seeds_s = (seeds + ((s * 0x9E3779B9) & rng.M32)) & rng.M32
        if config.jitter:
            jx, seeds_s = rng.rand(seeds_s)
            jy, seeds_s = rng.rand(seeds_s)
            o, d = _rays_at(
                cam, config,
                px.to(torch.float32) + torch.where(frame == 0, 0.5, jx),
                py.to(torch.float32) + torch.where(frame == 0, 0.5, jy))
        else:
            o, d = rays
        take_gb = want_gbuffer and s == 0
        out = trace_paths(scene, accel, o, d, seeds_s, config, plain=plain,
                          want_gbuffer=take_gb, _batches=_batches)
        if take_gb:
            out, gbuffer = out
        acc = out if acc is None else acc + out
    img = (acc * (1.0 / config.spp)).to_array()
    img = img.reshape(rows, config.width, 3)
    if not want_gbuffer:
        return img
    return img, {k: v.reshape((rows, config.width) + v.shape[1:])
                 for k, v in gbuffer.items()}


# render_frames' captured programs (graphs.Programs): a few keys at once,
# since one process may render many configs, and each graph holds its own
# memory pool.
FRAME_PROGRAMS = graphs.Programs(4)


def render_frames(scene: SceneData, accel, cam: CameraArrays,
                  frame0, k: int, config: RenderConfig,
                  plain: bool = False) -> torch.Tensor:
    """Render frames frame0, ..., frame0 + k - 1 -> (k, H, W, 3), the k
    frames in one program, as the JAX package's jit of a scan: on the
    card one CUDA graph per (config, k, camera shapes, scene and accel
    tensors), captured at its first call and replayed after
    (graphs.Programs; op by op with `plain`, on the CPU and in
    graphs.disable()).  `frame0` is an int or a 0-d integer tensor; the
    frame index frame0 + i is a tensor on the device.  The pixel planes,
    and the camera rays when there is no jitter, are computed once for
    the k frames."""

    def body(cam, frame0):
        pre = _primary_setup(cam, config.height, 0, config)
        return torch.stack([
            render_rows(scene, accel, cam, 0, config.height, config,
                        plain=plain, frame=frame0 + i, _pre=pre)
            for i in range(k)])

    key = ("render_frames", config, k, graphs.signature(scene),
           graphs.signature(accel))
    return FRAME_PROGRAMS(key, body, (cam, frame0), cam.origin.device,
                          eager=plain)


def render_frame(scene: SceneData, accel, cam: CameraArrays, frame,
                 config: RenderConfig, plain: bool = False) -> torch.Tensor:
    """Render frame `frame` -> (H, W, 3) linear radiance on the scene's
    device: render_frames(..., frame, 1, config)[0]."""
    return render_frames(scene, accel, cam, frame, 1, config,
                         plain=plain)[0]


def render(scene_obj, cam: Camera, config: RenderConfig, accel=None,
           frame: int = 0, plain: bool = False, device=None):
    """Host entry: build the scene if needed and render frame `frame` ->
    (H, W, 3) numpy array.  `accel` is an Accel, a TwoLevelFlat, or None
    to trace by brute force.  The device is `device`, else the accel's,
    else a built SceneData's, else the first CUDA device
    (config.resolve_device: raises without a card)."""
    if device is None and accel is not None:
        device = accel.tris.device
    elif device is None and isinstance(scene_obj, SceneData):
        device = scene_obj.tri_v0.device
    device = resolve_device(device)
    scene = (scene_obj.build(device) if isinstance(scene_obj, Scene)
             else scene_obj)
    cams = camera_arrays(cam, config, device)
    return render_frame(scene, accel, cams, frame, config,
                        plain=plain).cpu().numpy()
