"""The benchmark of yogo_tpu_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

`python3 -m yogo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line (README.md).
Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own that the harness finds by name:
configs/<config>.json, traffic/<mix>.json (which names its driver in
drivers/), limits/<cell>.json and metrics/<metric>.py.

Nothing here imports jax, jaxlib, flax or yogo_tpu (the JAX package); the
plain reference (reference.py) imports nothing of yogo_tpu_torch either.
"""
