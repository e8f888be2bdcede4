"""The benchmark of the PyTorch and CUDA port (``refinedet_tpu_torch``).

``python3 -m portbench.run --workload NAME --seed N --seconds S --trace
0|1`` runs one cell of ``BENCHMARK.json`` once (see ``run.py``). It
imports neither JAX nor the JAX package; ``reference/`` imports nothing
of the port.
"""
