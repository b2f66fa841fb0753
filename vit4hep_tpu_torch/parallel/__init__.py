"""The multi-device layer (port of ``vit4hep_tpu/parallel/``): the (data,
model) grid of ranks and its collectives (``mesh``, ``_comm``), Megatron
tensor parallelism (``sharding_rules``), ring attention
(``sequence_parallel``) and the GPipe pipeline (``pipeline``)."""
