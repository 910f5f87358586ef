"""Process utilities of the port (counterpart of ``tf_operator_tpu/utils``)."""
