"""Tensor parallelism of one engine over torch.distributed (mesh.py, the
axes and this process's place; comm.py, the collectives; bootstrap.py, the
process group; launch.py, the ranks as processes)."""
