"""Render configuration, field for field the JAX package's RenderConfig.

Keeping every field (and its default) lets one config object describe
the same frame to both packages.  Knobs that only steer TPU speed
(`shade_pallas`, `block_reorder`, `shadow_interleave`,
`shadow_from_light`, `tri_chunk`, `leaf_size`) are accepted and do not
change this package's output.  `traversal="bruteforce"` traces a
single-level scene against every triangle (no accel), as the JAX
package does; the other values walk the accel.  `light_sampler` picks
the sampled NEE's light sampler: "bvh" the light-tree descent, "auto"
the tree past 384 lights, anything else the flat CDF scan.  `CONFIGS`
holds the JAX package's named benchmark configurations.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800
    height: int = 600
    spp: int = 1
    max_depth: int = 2
    light_threshold: float = 1e-4
    sky: bool = False
    jitter: bool = False
    indirect: bool = False
    russian_roulette: bool = True
    rr_start_depth: int = 2
    normal_offset: float = 1e-4
    bounce_offset: float = 1e-3
    t_min: float = 1e-3
    traversal: str = "auto"          # bruteforce | bvh | pallas | auto
    leaf_size: int = 0
    tri_chunk: int = 512
    block_reorder: bool = True
    sort_bounces: bool = False
    brdf: str = "disney"             # disney | pbr
    shade_pallas: bool = True
    light_samples: int = 0
    denoise: bool = False
    upscale: int = 1
    upscale_mode: str = "spatial"
    light_sampler: str = "auto"
    accumulate: bool = False
    shadow_interleave: bool = True
    shadow_from_light: bool = False

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


# The JAX package's named benchmark configurations
# (hrt_tpu/config.py CONFIGS), field for field.
CONFIGS = {
    "primary": RenderConfig(width=800, height=600, max_depth=1, sky=True),
    "whitted": RenderConfig(width=800, height=600, max_depth=4, sky=True,
                            indirect=True, russian_roulette=False),
    "mesh_bvh": RenderConfig(width=800, height=600, max_depth=2, sky=True,
                             traversal="pallas"),
    "path_tracing": RenderConfig(width=1920, height=1080, max_depth=5,
                                 sky=True, indirect=True, jitter=True,
                                 accumulate=True, traversal="pallas"),
    "animated_4k": RenderConfig(width=3840, height=2160, max_depth=3,
                                sky=True, indirect=True, jitter=True,
                                denoise=True, upscale=2,
                                traversal="pallas"),
    "reference_parity": RenderConfig(),
}


def require_slice(config: RenderConfig) -> None:
    """Raise ValueError for an upscale_mode the JAX package does not
    know.  Every other feature of RenderConfig is ported: the path
    tracer (the Disney BRDF or the pbr BSDF, textures, a shadow ray per
    light or `light_samples` sampled lights, sky on miss, bounces with
    Russian roulette, jitter, the sorted wavefront), its post stages
    (accumulate, SVGF, the spatial or temporal 2x upscaler) and both
    traversals (an accel's walk, or brute force)."""
    if config.upscale_mode not in ("spatial", "temporal"):
        raise ValueError(f"upscale_mode must be 'spatial' or 'temporal', "
                         f"not {config.upscale_mode!r}")


def resolve_device(device) -> torch.device:
    """`device`, or the first CUDA device when it is None.  Never picks
    the CPU on its own: with no card, a None or CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain PyTorch versions")
    return dev
