"""The benchmark of the PyTorch / CUDA port (``rpvg_tpu_torch``).

``python3 bench_port/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell; ``README.md`` says how the
harness finds configurations, traffic mixes and per-layer metrics by
name.  Nothing here imports ``jax`` or the JAX package; the plain
reference (:mod:`bench_port.reference`) imports nothing of the port.
"""
