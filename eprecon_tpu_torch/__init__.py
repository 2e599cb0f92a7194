"""EPRecon on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `eprecon_tpu` that mirrors its module layout:
`ops/` (geometry, back-projection with its hand-written CUDA kernels,
forward and backward, registered as torch custom ops; compaction and the
sparse voxel engine; TSDF fusion for the GT), `models/` (backbone,
occupancy init, dense 3D U-Nets, GRU fusion, panoptic decoder, matcher and
criterion, the SPVCNN research engine), `inference/` (streaming
reconstruction, mesh export, the torch.export serving artifact and its
model-free loader), `fragment_io.py` (the fragment program's call
convention), `train/` (losses, optimizer and the single-card training step,
checkpoints, the training and evaluation loops), `data/` (the ScanNet
dataset and its transforms, the sampler, synthetic scenes, point-cloud
exports), `tools/` (scene scores, data and import tools, the mesh
viewer), `utils/`, `convert.py` (flax trees -> torch modules) and
`main.py`, the training/evaluation CLI.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a
machine without CUDA they raise instead of falling back to the CPU.
"""
