"""Multi-device over torch.distributed: the process group and its (data,
model) mesh, the owner split of the optimizer state, rank-sharded serving
(tooncrafter_tpu/parallel/)."""
