"""Parallelism of the port (counterpart of `repro.parallel`): so far the
mesh context that the MoE dispatch reads (`sharding`)."""
