"""Data feeding of the port (``paddle_tpu.io`` counterpart): sequence
packing."""
from paddle_tpu_torch.io.packing import (SequencePacker, pack_examples,
                                         pad_examples, unpack_batch)

__all__ = ["SequencePacker", "pack_examples", "pad_examples",
           "unpack_batch"]
