"""The port's observability plane (``paddle_tpu.observability``
counterpart): the structured event journal (``events``), which the tuning
plane emits through. The JAX package's metrics registry and tracing spans
(``metrics.py``, ``tracing.py``) are not ported yet."""
from paddle_tpu_torch.observability import events  # noqa: F401
from paddle_tpu_torch.observability.events import EventJournal, journal

__all__ = ["events", "EventJournal", "journal"]
