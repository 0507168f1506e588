"""Incubating APIs of the port (``paddle_tpu.incubate`` counterpart)."""
