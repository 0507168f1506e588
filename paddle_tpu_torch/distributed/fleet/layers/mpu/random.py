"""reference: fleet/layers/mpu/random.py: the tracker of
``distributed.fleet.rng`` (``RNGStatesTracker`` :34,
``get_rng_state_tracker`` :99)."""
from paddle_tpu_torch.distributed.fleet.rng import (  # noqa: F401
    MODEL_PARALLEL_RNG, RNGStatesTracker, get_rng_state_tracker,
    model_parallel_random_seed, model_parallel_rng)
