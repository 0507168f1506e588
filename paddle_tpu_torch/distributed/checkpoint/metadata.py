"""Distributed checkpoint metadata (``paddle_tpu.distributed.checkpoint.
metadata`` counterpart; reference: python/paddle/distributed/checkpoint/
metadata.py:20-40, LocalTensorMetadata / LocalTensorIndex / Metadata). The
metadata maps each saved shard (global offset + local shape) to the file
that holds it, so a checkpoint saved under one layout loads under
another."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["LocalTensorMetadata", "LocalTensorIndex", "Metadata"]


@dataclass(frozen=True)
class LocalTensorMetadata:
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True)
class LocalTensorIndex:
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = field(default_factory=dict)
    storage_metadata: Dict[LocalTensorIndex, str] = field(default_factory=dict)
    flat_mapping: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
