"""Multi-device and multi-process training on torch.distributed."""
