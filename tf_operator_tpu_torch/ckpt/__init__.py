"""The workload half of the operator's checkpoint protocol (counterpart
of ``tf_operator_tpu/ckpt``)."""
