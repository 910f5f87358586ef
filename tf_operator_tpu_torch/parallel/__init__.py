"""Meshes over processes and their placement: the port's counterpart of
``tf_operator_tpu/parallel/`` (``mesh``, ``sharding``: data, FSDP,
ZeRO-1 and tensor parallelism; ``ring_attention`` and ``ulysses``:
sequence parallelism; ``pipeline``: GPipe and 1F1B over a ``pp``
axis)."""
