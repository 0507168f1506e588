from paddle_tpu_torch.distributed.fleet.elastic.manager import (  # noqa: F401
    ELASTIC_EXIT_CODE, ElasticManager, ElasticStatus,
)
