"""Fleet optimizers: the hybrid-parallel one and ZeRO-1/2 sharding."""
