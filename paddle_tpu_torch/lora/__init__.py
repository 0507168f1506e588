"""Multi-tenant LoRA of the port (``paddle_tpu.lora`` counterpart):
adapter train -> export -> serve on one base model.

Lazy (PEP 562) as in the JAX package: the models import
``paddle_tpu_torch.lora.seam`` at module load to consult the projection
seam, so this package does not pull in the adapter and store stacks
(artifact, observability, resilience) until an attribute asks for them.
"""
from __future__ import annotations

from paddle_tpu_torch.lora import seam  # light: stdlib + torch

__all__ = ["seam", "LoRAConfig", "LoRAAdapter", "attach", "detach",
           "export_adapter", "load_adapter", "find_targets",
           "DEFAULT_TARGETS", "AdapterStore", "AdapterLoadError"]

_ADAPTER = ("LoRAConfig", "LoRAAdapter", "attach", "detach",
            "export_adapter", "load_adapter", "find_targets",
            "DEFAULT_TARGETS")
_STORE = ("AdapterStore", "AdapterLoadError")


def __getattr__(name):
    if name in _ADAPTER:
        from paddle_tpu_torch.lora import adapter
        return getattr(adapter, name)
    if name in _STORE:
        from paddle_tpu_torch.lora import store
        return getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
