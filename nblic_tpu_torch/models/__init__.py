"""Codec engines of the port (counterparts of nblic_tpu.models)."""
