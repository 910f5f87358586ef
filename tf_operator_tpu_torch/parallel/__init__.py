"""Meshes over processes and data-parallel placement: the port's
counterpart of ``tf_operator_tpu/parallel/`` (its data-parallel half)."""
