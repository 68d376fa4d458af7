"""The benches: one module for each of the JAX repository's bench entry
points, each runnable as ``python -m bevyray_tpu_torch.bench.<name>``.

- :mod:`.headline` (``bench.py``): the final scene at 1080p, 16 spp;
- :mod:`.matrix` (``scripts/bench_matrix.py``): BASELINE configs 1-5, then
  the orbit rows at 720p;
- :mod:`.orbit` (``scripts/bench_orbit.py``): a moving camera and per-frame
  sphere edits, synced and pipelined;
- :mod:`.edit` (``scripts/bench_edit.py``): the edit-to-frame loop, stage by
  stage;
- :mod:`.scaling` (``scripts/scaling_bench.py``): both sharded steps over
  1, 2, 4 and 8 shards.

Each runs on the CUDA card and raises without one; ``--device cpu`` runs the
plain PyTorch versions instead. :mod:`.timing` holds what they share.
"""
