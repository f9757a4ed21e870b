"""The benchmark's plain reference: the path tracer and its post stages
in plain PyTorch, written again from the renderer's published math (the
reference shaders' RNG, camera, Disney BRDF, samplers and sky; SVGF;
the learned 2x temporal upscaler).  It imports nothing of the program:
it flattens the scene from the benchmark's own arrays, finds hits by
brute force over every triangle (no acceleration structure), and reads
only the upscaler's weight file, which both sides read.

`pathtrace` renders any set of pixels of a frame, `post` runs the
post stages on whole frames.  Both run on the card after the measured
window, or on the CPU in the tests.
"""
