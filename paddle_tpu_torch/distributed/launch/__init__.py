"""``python -m paddle_tpu_torch.distributed.launch``: the launcher
(``main``)."""
from paddle_tpu_torch.distributed.launch.main import launch  # noqa: F401
