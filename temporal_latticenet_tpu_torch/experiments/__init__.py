"""The accuracy experiments: seeded ray-cast LiDAR worlds written in the
SemanticKITTI on-disk format and driven through the loader, the training
loop, the metrics and the prediction writer.

- ``train_lidar``: the moving-class comparison (temporal, accumulated and
  single-frame models on identical dynamic-actor worlds) and the
  multi-world generalization run;
- ``overfit_lidar``: the full-stack overfit on one world;
- ``occupancy_worlds`` and ``occupancy``: the per-level lattice occupancy
  that sizes the runs' vertex capacities;
- ``moving_table``: the Markdown table of the moving-class comparison.

Each runs as ``python -m temporal_latticenet_tpu_torch.experiments.<name>``,
on CUDA unless ``--cpu`` is given.
"""
