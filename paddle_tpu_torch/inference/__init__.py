"""Inference front-ends of the port (``paddle_tpu.inference``
counterpart)."""
