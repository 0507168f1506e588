"""Serving of the port (``paddle_tpu.serving`` counterpart): paged KV
cache, continuous batching, sampling, the n-gram draft proposer, the
engine (multi-tenant LoRA through ``lora.AdapterStore``), the replica
transport seam and the fleet router."""
from paddle_tpu_torch.serving.drafts import NGramProposer
from paddle_tpu_torch.serving.engine import ServingConfig, ServingEngine
from paddle_tpu_torch.serving.kv_cache import (PageAllocator, kv_page_bytes,
                                               pages_for_budget)
from paddle_tpu_torch.serving.replica import (InProcessReplica, ReplicaDead,
                                              ReplicaError, StreamCut,
                                              StreamGap)
from paddle_tpu_torch.serving.router import (Router, RouterConfig,
                                             backoff_delays,
                                             rendezvous_order)
from paddle_tpu_torch.serving.sampling import request_generator, sample_tokens
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                QueueFull, Request,
                                                RequestState)

__all__ = ["ServingConfig", "ServingEngine", "PageAllocator",
           "kv_page_bytes", "pages_for_budget", "sample_tokens",
           "request_generator", "ContinuousBatchingScheduler", "QueueFull",
           "Request", "RequestState", "NGramProposer", "InProcessReplica",
           "ReplicaError", "ReplicaDead", "StreamGap",
           "StreamCut", "Router", "RouterConfig", "rendezvous_order",
           "backoff_delays"]
