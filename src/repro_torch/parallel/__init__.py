"""Parallelism of the port: the collectives, the sharding rules and the
pipeline schedule, over ``torch.distributed``."""
