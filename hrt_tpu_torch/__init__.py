"""hrt_tpu_torch — the path tracer on PyTorch + CUDA (NVIDIA Hopper).

A second package beside the JAX reference `hrt_tpu`.  It renders the
path tracer (Disney BRDF or the pbr BSDF, textures, a shadow ray per
light or sampled lights by the CDF scan or the light tree, sky on miss,
bounces) on single-level and two-level (instanced) scenes, and its post
stages (accumulate, SVGF, the learned 2x upscalers), through
hand-written CUDA kernels:

- ``ops/traversal_wide8`` — the BVH8 walk (K1), ``csrc/bvh8_trace.cu``;
- ``ops/traversal_skip`` — the binary skip-link walk (K3) of accels
  without a BVH8 table (the LBVH of a culling rebuild, SAH trees past
  the wide bound), ``csrc/skip_trace.cu``;
- ``ops/traversal_tlas8`` — the two-level BVH8 walk (K4),
  ``csrc/tlas8_trace.cu``;
- ``ops/traversal_tlas_skip`` — the binary two-level walk (K5) of
  instance scenes past the wide bound, ``csrc/tlas_skip_trace.cu``;
- ``ops/shade_kernel`` — the light-major Disney BRDF (K2),
  ``csrc/brdf_light_major.cu``;
- ``ops/warp_kernel`` — the bilinear reprojection warp (K6) of SVGF's
  history and the temporal upscaler's, ``csrc/warp_bilinear.cu``.

The walks run closest hit and any hit.  Each kernel has a plain PyTorch
version beside it, used for CPU tensors (and by the tests); CUDA tensors
always go to the kernel.  ``traversal="bruteforce"`` traces against
every triangle in plain PyTorch instead of walking an accel, and
``ops/twolevel`` is the stacked per-mesh two-level accel, each BLAS
walked by K3.

``parallel/`` renders over several GPUs on ``torch.distributed``: row
bands of each frame (``tiles.py``), the triangle pool sharded across
ranks (``scene_shard.py``) and frame ranges per process (``farm.py``).

Users start it as ``python -m hrt_tpu_torch.render`` (``cli.py``; the
live preview is ``preview.py``); ``utils/`` holds the PNG writer, logging,
profiling and the upscaler's ``.npz`` checkpoints.  The package imports
neither ``jax`` nor ``hrt_tpu``, nor the JAX benchmark; PIL is imported
only when a scene file's ``image:`` texture is loaded.
"""

__version__ = "0.1.0"
