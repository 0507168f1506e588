"""Data feeding of the port (``paddle_tpu.io`` counterpart): sequence
packing and the asynchronous device feed."""
from paddle_tpu_torch.io.device_feed import (DeviceFeeder, DispatchWindow,
                                             FeederWorkerError, LossFuture,
                                             prefetch_to_device)
from paddle_tpu_torch.io.packing import (SequencePacker, pack_examples,
                                         pad_examples, unpack_batch)

__all__ = ["SequencePacker", "pack_examples", "pad_examples",
           "unpack_batch", "DeviceFeeder", "DispatchWindow",
           "FeederWorkerError", "LossFuture", "prefetch_to_device"]
