"""The benchmark of gaussdca_tpu_torch, the PyTorch and CUDA port: whole
protein families through the port's batch front end on one card.

``run.py`` is the command; ``BENCHMARK.json`` at the checkout's root
names the cells. See ``spec.py`` for where each cell's files live.
"""
