"""rtbench: the benchmark of the PyTorch and CUDA port (hrt_tpu_torch).

`run.py` is its command; BENCHMARK.json at the repository's root names
its cells, configurations (`configs/`), traffic mixes (`traffic/`),
per-layer metric readers (`metrics/`) and the comparison's limits
(`limits/`); `reference/` is the plain reference the comparison holds
the program to.  Nothing here imports JAX or the JAX package.
"""
