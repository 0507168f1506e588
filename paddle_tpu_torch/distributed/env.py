"""The distributed environment (``paddle_tpu.distributed.env`` counterpart;
reference: python/paddle/distributed/parallel.py ``ParallelEnv`` and its
env contract).

The port runs one OS process per rank. A rank's identity comes from the
launch contract (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``), and, once ``init_parallel_env`` has joined the
process group, from ``torch.distributed`` itself.
"""
from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ["ParallelEnv", "get_rank", "get_world_size"]


class ParallelEnv:
    @property
    def rank(self) -> int:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return int(os.getenv("PADDLE_TRAINER_ID", "0"))

    @property
    def world_size(self) -> int:
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return int(os.getenv("PADDLE_TRAINERS_NUM", "1"))

    @property
    def local_rank(self) -> int:
        return int(os.getenv("PADDLE_LOCAL_RANK", str(self.rank)))

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def dev_id(self) -> int:
        return self.local_rank

    @property
    def device_type(self) -> str:
        return "gpu"

    @property
    def trainer_endpoints(self):
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    @property
    def current_endpoint(self):
        return os.getenv("PADDLE_CURRENT_ENDPOINT", "")


def get_rank(group=None) -> int:
    """This process's rank: its index in `group` when one is given, else
    its global rank."""
    if group is not None:
        return group.rank
    return ParallelEnv().rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return ParallelEnv().world_size
