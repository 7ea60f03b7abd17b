"""The benchmark's plain float32 reference of Temporal LatticeNet.

A frozen copy of the port's plain PyTorch code (the model, the lattice
built again from the points, the losses) with every hand-written kernel
replaced by its plain version, so that later changes to the port cannot
move the yardstick.  It is cut to what the benchmark's cells drive: the
per-frame pointnet over the whole-sequence lattice, the GRU and AFlow
fusions, no trims, no dropout, no experiment (the streaming cells' answers
are compared with this sequence forward).  It imports nothing of the port,
of JAX or of the JAX package.  ``engine`` holds the entries the benchmark compares with: the
whole-sequence forward and three training steps of AdamW(amsgrad).

The reference runs with ``compute_dtype="float32"`` and TF32 off; the
precision control runs it with ``"float8_e4m3fn"``, which rounds the
operands the port rounds to bf16 (the lattice convolutions and the
pointnet MLP) to float8 with one scale per tensor.
"""
