"""Frame sharding over torch.distributed."""
