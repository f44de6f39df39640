"""Tensor ops of the port (counterparts of nblic_tpu.ops)."""
