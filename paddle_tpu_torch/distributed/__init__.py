"""Distributed utilities of the port (``paddle_tpu.distributed``
counterpart); only the fault-injection registry is ported so far."""
