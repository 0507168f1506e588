"""Training steps of the port (``paddle_tpu.parallel`` counterpart)."""
from paddle_tpu_torch.parallel.train_step import TrainStep

__all__ = ["TrainStep"]
