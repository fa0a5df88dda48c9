"""The benchmark of the PyTorch and CUDA port (``strange_attractor_tpu_torch``).

One run of one cell: ``python3 -m bench_torch.run --workload NAME --seed N
--seconds S --trace 0|1`` from the root of a checkout (see README.md).
"""
