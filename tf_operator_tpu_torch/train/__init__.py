"""Training steps of the port (counterpart of ``tf_operator_tpu/train``)."""
