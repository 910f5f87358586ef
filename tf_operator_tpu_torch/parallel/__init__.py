"""Meshes over processes and their placement: the port's counterpart of
``tf_operator_tpu/parallel/`` (``mesh``, ``sharding``: data, FSDP,
ZeRO-1 and tensor parallelism; ``ring_attention`` and ``ulysses``:
sequence parallelism). JAX's ``pipeline`` waits for ROADMAP A8d."""
