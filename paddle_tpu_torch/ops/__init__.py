"""Operators of the port (``paddle_tpu.ops`` counterpart)."""
