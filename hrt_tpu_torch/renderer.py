"""The direct-lighting frame: raygen -> closest hit -> attribute
gather + sky -> Disney BRDF (K2) + shadow any-hit -> accumulate.

The accel is either a single-level Accel (ops/lbvh.py), traced by K1
when it has a BVH8 table and by K3 when it has not (an LBVH, or a SAH
tree past MAX_WIDE_NODES), or a two-level TwoLevelFlat (ops/tlas.py),
traced by K4 (BVH8 route) or K5 (binary route) and shaded through the
hit instance's normal matrix and material.

The subset of hrt_tpu/renderer.py that the benchmark frame runs
(`max_depth=1`, no jitter, one shadow ray per light), in plain PyTorch
around the kernels.  Per-pixel output is the JAX package's; only the
ray order differs: rays stay in pixel order (the TPU's pixel-block
reorder and shadow interleave are layouts for its packet tiles), the
shadow batch is light-major concatenated, and the k frames of
`render_frames` are a Python loop over primary rays computed once.

Every entry point takes `plain=False`; `plain=True` routes the walks
and the BRDF to their plain PyTorch versions on whatever device the
tensors are on, which is how a reference frame is rendered on the card.
`trace_paths` and `render_rows` also return the first hit's G-buffer
when asked (`want_gbuffer`), for the post stages (ops/denoise.py,
models/upscaler.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import RenderConfig, require_slice
from .models.camera import Camera, CameraArrays, primary_rays_from_px_p
from .models.lights import process_light_one
from .models.materials import MatP
from .models.scene import Scene, SceneData
from .models.sky import eval_sky_p
from .ops import shade_kernel, tlas, traversal, v3
from .ops.intersect import INF
from .ops.lbvh import ATTR_MAT, Accel
from .ops.tlas import TwoLevelFlat
from .ops.v3 import V3


def camera_arrays(cam: Camera, config: RenderConfig, device) -> CameraArrays:
    return cam.ray_params(config.width, config.height, device)


def _zero3(like) -> V3:
    z = torch.zeros_like(like)
    return V3(z, z, z)


def _shade_attrs_p(tab: torch.Tensor, tri_idx, u, v):
    """Hit attributes from one gather of the (T, 16 + MAT_W) table by
    leaf-pool id.  Returns (unit normal V3, MatP)."""
    rt = tab[tri_idx.clamp(min=0).long()].T          # (W, N)
    w = 1.0 - u - v
    normal = v3.normalize(V3(
        w * rt[0] + u * rt[3] + v * rt[6],
        w * rt[1] + u * rt[4] + v * rt[7],
        w * rt[2] + u * rt[5] + v * rt[8]))
    return normal, MatP.from_rows_t(rt, base=ATTR_MAT)


class LightBatch(NamedTuple):
    """Next-event terms of all lights, light-major over (L*N,): the
    direction to the light `l`, `relevant` (BRDF can be nonzero, light
    above threshold, ray hit a surface), the shadow segment's `t_max`
    (-1 on irrelevant lanes), the shadow origins, and per light its
    color and intensity plane."""

    l: V3
    relevant: torch.Tensor
    t_max: torch.Tensor
    origin: V3
    color: list
    intensity: list


def light_batch(scene: SceneData, n: V3, world_pos: V3,
                config: RenderConfig, ray_mask=None) -> LightBatch:
    """One shadow ray per light (ref: calculateColor,
    shaders/raytracing.slang:72-88), concatenated light-major."""
    shadow_o = world_pos + n * config.normal_offset
    ls, rels, sts, cols, ints = [], [], [], [], []
    for i in range(scene.lights.shape[0]):
        ldir, lcol, lint, unb = process_light_one(scene.lights[i],
                                                  world_pos)
        l = v3.normalize(ldir)
        relevant = (v3.dot(n, l) > 0.0) & (lint >= config.light_threshold)
        if ray_mask is not None:
            relevant = relevant & ray_mask
        # Directional lights shadow to infinity, others to the light.
        reach = torch.where(unb, INF, v3.length(ldir))
        ls.append(l)
        rels.append(relevant)
        sts.append(torch.where(relevant, reach, -1.0))
        cols.append(lcol)
        ints.append(lint)
    cat = torch.cat
    num_lights = len(ls)
    return LightBatch(
        l=V3(cat([a.x for a in ls]), cat([a.y for a in ls]),
             cat([a.z for a in ls])),
        relevant=cat(rels), t_max=cat(sts),
        origin=shadow_o.map(lambda a: a.repeat(num_lights)),
        color=cols, intensity=ints)


def direct_lighting_p(scene: SceneData, accel, mat: MatP, n: V3,
                      view: V3, world_pos: V3, config: RenderConfig,
                      ray_mask=None, plain: bool = False) -> V3:
    """Direct light at the hit points: the BRDF of all lights in one K2
    call, all shadow rays in one light-major any-hit call (the accel's
    walk: K1 or K3, K4 or K5 for a two-level accel)."""
    num_lights = scene.lights.shape[0]
    if num_lights == 0:
        return _zero3(n.x)
    lb = light_batch(scene, n, world_pos, config, ray_mask)
    brdf = (shade_kernel.brdf_light_major_plain if plain
            else shade_kernel.brdf_light_major)
    f_lm = brdf(mat, n, view, lb.l, lb.relevant, num_lights)
    if isinstance(accel, TwoLevelFlat):
        occluded = tlas.any_hit_tlas(accel, lb.origin, lb.l, config.t_min,
                                     lb.t_max, plain=plain)
    else:
        occluded = traversal.any_hit_bvh_p(scene, accel, lb.origin, lb.l,
                                           config.t_min, lb.t_max,
                                           plain=plain)
    nr = n.x.shape[0]
    out = _zero3(n.x)
    for i in range(num_lights):
        sl = slice(i * nr, (i + 1) * nr)
        vis = 1.0 - occluded[sl].to(torch.float32)
        contrib = f_lm.map(lambda a: a[sl]) * lb.color[i] * lb.intensity[i]
        out = out + v3.where(lb.relevant[sl], contrib * vis, 0.0)
    return out


class SurfaceHits(NamedTuple):
    """Closest hits of a camera ray batch and their shading inputs."""

    t: torch.Tensor
    hit: torch.Tensor
    normal: V3          # unit, facing the viewer
    mat: MatP
    world_pos: V3
    view: V3


def surface_hits(scene: SceneData, accel, o: V3, d: V3,
                 config: RenderConfig, plain: bool = False) -> SurfaceHits:
    """Closest hit and the attribute gather: by leaf-pool id from the
    Accel's table (K1 or K3), or by global pool id and instance from the
    TwoLevelFlat (K4 or K5)."""
    if isinstance(accel, TwoLevelFlat):
        t, tri, inst, u, v = tlas.closest_hit_tlas(
            accel, o, d, config.t_min, INF, plain=plain)
        nrm, mat = tlas.shade_attrs_tlas(accel, scene.materials, tri,
                                         inst, u, v)
    else:
        t, tri, u, v = traversal.closest_hit_bvh_p(
            scene, accel, o, d, config.t_min, INF, sorted_ids=True,
            plain=plain)
        nrm, mat = _shade_attrs_p(accel.attr, tri, u, v)
    view = -d
    entering = v3.dot(nrm, view) >= 0.0
    nrm = v3.where(entering, nrm, -nrm)
    return SurfaceHits(t, tri >= 0, nrm, mat, o + d * t, view)


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


def trace_paths(scene: SceneData, accel, o: V3, d: V3,
                config: RenderConfig, plain: bool = False,
                want_gbuffer: bool = False):
    """Radiance of one camera ray batch at depth 0: sky on a miss,
    direct light plus emission on a hit.  With `want_gbuffer`, returns
    (radiance, _gbuffer(first hits))."""
    require_slice(config)
    if not isinstance(accel, (Accel, TwoLevelFlat)):
        raise NotImplementedError(
            "only the single-level Accel and the two-level TwoLevelFlat "
            "are ported (no brute-force frame path)")
    if scene.textures is not None and scene.textures.shape[0] > 0:
        raise NotImplementedError("textured scenes are not ported yet")
    radiance = _zero3(o.x)
    if config.max_depth < 1:
        if not want_gbuffer:
            return radiance
        n = o.x.shape[0]
        zeros = lambda *s: torch.zeros((n, *s), device=o.x.device)
        return radiance, {"normal": zeros(3), "depth": zeros(),
                          "albedo": zeros(3) + 1.0, "world_pos": zeros(3),
                          "hit": zeros()}
    sh = surface_hits(scene, accel, o, d, config, plain=plain)
    sky_rad = eval_sky_p(scene.sky, d, enabled=config.sky)
    radiance = radiance + v3.where(~sh.hit, sky_rad, 0.0)
    direct = direct_lighting_p(scene, accel, sh.mat, sh.normal, sh.view,
                               sh.world_pos, config, ray_mask=sh.hit,
                               plain=plain)
    emissive = sh.mat.emissive * sh.mat.emission_strength
    radiance = radiance + v3.where(sh.hit, direct + emissive, 0.0)
    return (radiance, _gbuffer(sh)) if want_gbuffer else radiance


def primary_rays(cam: CameraArrays, rows: int, y0: int,
                 config: RenderConfig):
    """Camera rays of rows [y0, y0 + rows) in pixel order."""
    dev = cam.origin.device
    w = config.width
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(rows, w).reshape(-1)
    py = (torch.arange(rows, dtype=torch.float32, device=dev) + y0)[:, None] \
        .expand(rows, w).reshape(-1)
    return primary_rays_from_px_p(cam.origin, cam.basis, cam.tan_half_fovy,
                                  cam.aspect, w, config.height, px, py)


def render_rows(scene: SceneData, accel, cam: CameraArrays,
                y0: int, rows: int, config: RenderConfig,
                plain: bool = False, want_gbuffer: bool = False,
                _rays=None):
    """Render rows [y0, y0 + rows) -> (rows, W, 3) linear radiance, and
    with `want_gbuffer` also the first sample's G-buffer, each field
    (rows, W, ·) in pixel order.  _rays: primary rays computed once by
    render_frames."""
    o, d = _rays if _rays is not None else primary_rays(cam, rows, y0,
                                                         config)
    acc = _zero3(o.x)
    gbuffer = None
    for s in range(config.spp):
        take_gb = want_gbuffer and s == 0
        out = trace_paths(scene, accel, o, d, config, plain=plain,
                          want_gbuffer=take_gb)
        if take_gb:
            out, gbuffer = out
        acc = acc + out
    img = (acc * (1.0 / config.spp)).to_array()
    img = img.reshape(rows, config.width, 3)
    if not want_gbuffer:
        return img
    return img, {k: v.reshape((rows, config.width) + v.shape[1:])
                 for k, v in gbuffer.items()}


def render_frames(scene: SceneData, accel, cam: CameraArrays,
                  frame0: int, k: int, config: RenderConfig,
                  plain: bool = False) -> torch.Tensor:
    """Render k consecutive frames -> (k, H, W, 3).  The frame index only
    seeds sampling, which this slice does not do, so frame0 does not
    change the output."""
    rays = primary_rays(cam, config.height, 0, config)
    return torch.stack([
        render_rows(scene, accel, cam, 0, config.height, config,
                    plain=plain, _rays=rays)
        for _ in range(k)])


def render(scene_obj, cam: Camera, config: RenderConfig, accel,
           frame: int = 0, plain: bool = False):
    """Host entry: build the scene on the accel's device if needed and
    render one frame -> (H, W, 3) numpy array.  `accel` is an Accel or
    a TwoLevelFlat."""
    device = accel.tris.device
    scene = (scene_obj.build(device) if isinstance(scene_obj, Scene)
             else scene_obj)
    cams = camera_arrays(cam, config, device)
    img = render_frames(scene, accel, cams, frame, 1, config, plain=plain)
    return img[0].cpu().numpy()
