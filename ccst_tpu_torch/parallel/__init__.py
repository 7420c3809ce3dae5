"""Client-parallel and multi-process training, and the sharded stylize and
classifier paths, on torch.distributed."""
