"""Distributed utilities of the port (``paddle_tpu.distributed``
counterpart); ported so far: the fault-injection registry
(``resilience.faults``) and the TCPStore with rank heartbeats
(``store``)."""
