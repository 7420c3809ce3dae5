"""Client-parallel and multi-process training on torch.distributed."""
