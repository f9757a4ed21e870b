"""hrt_tpu_torch — the path tracer on PyTorch + CUDA (NVIDIA Hopper).

A second package beside the JAX reference `hrt_tpu`.  It renders the
direct-lighting frame (primary closest hit, Disney BRDF, one shadow ray
per light, sky on miss) through two hand-written CUDA kernels:

- ``ops/traversal_wide8`` — the BVH8 walk (closest hit and any hit),
  source ``csrc/bvh8_trace.cu``;
- ``ops/shade_kernel`` — the light-major Disney BRDF, source
  ``csrc/brdf_light_major.cu``.

Each kernel has a plain PyTorch version beside it, used for CPU tensors
(and by the tests); CUDA tensors always go to the kernel.  The package
imports neither ``jax`` nor ``hrt_tpu``.
"""

__version__ = "0.1.0"
