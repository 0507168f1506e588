"""Training steps of the port (``paddle_tpu.parallel`` counterpart): the
single-device and hybrid ``TrainStep``, the pipelined steps (1F1B/VPP
``PipelinedTrainStep``, ZB-H1 ``ZBH1PipelinedStep``) and their schedule
tables."""
from paddle_tpu_torch.parallel import pipeline_schedules  # noqa: F401
from paddle_tpu_torch.parallel.pipeline import PipelinedTrainStep
from paddle_tpu_torch.parallel.segments import (  # noqa: F401
    current_segment_ctx, segment_execution)
from paddle_tpu_torch.parallel.train_step import TrainStep
from paddle_tpu_torch.parallel.zero_bubble import ZBH1PipelinedStep

__all__ = ["TrainStep", "PipelinedTrainStep", "ZBH1PipelinedStep"]
