"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA H100.

One cell, one run:

    python3 chipbench/run.py --workload dsv2lite.chat --seed 7 --seconds 10 --trace 0

`BENCHMARK.json` at the root lists the cells; everything that belongs to
one configuration, traffic mix, cell or per-layer metric is a file of its
own, found by name:

- ``configs/<config>.json``: the model's sizes as run, with ``bench``
  (the reference family, dtype, capacity rule, weight scales);
- ``reference/<family>.py``: the plain f32 reference, its FLOP count and
  its flash calls (imports nothing of the port);
- ``adapters/<family>.py``: the port's `ModelConfig` built from the file;
- ``traffic/<traffic>.json``: slots, the multiset of prompt lengths,
  generated tokens, the sample compared;
- ``limits/<cell>.json``: the limits of the numbers that decide `correct`;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports ``jax`` or the JAX package ``repro``.
"""
