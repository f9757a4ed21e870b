"""Multi-GPU rendering on torch.distributed (hrt_tpu/parallel/):
row-band tiles, scene-sharded tracing and the frame farm."""
