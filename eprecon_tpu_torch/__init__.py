"""EPRecon on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `eprecon_tpu` that mirrors its module layout:
`ops/` (geometry, back-projection with its hand-written CUDA kernel,
compaction), `models/` (backbone, occupancy init, dense 3D U-Nets, GRU
fusion, panoptic decoder), `inference/` (streaming reconstruction),
`convert.py` (flax variables -> torch modules) and `data/synthetic.py`.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a
machine without CUDA they raise instead of falling back to the CPU.
"""
