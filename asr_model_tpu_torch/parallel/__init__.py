"""Parallelism over ``torch.distributed``: the process mesh
(``mesh``), tensor / data / expert sharding and the sharded train step
(``sharding``), sequence parallelism (``seq``) and the GPipe pipeline
(``pipeline``)."""
