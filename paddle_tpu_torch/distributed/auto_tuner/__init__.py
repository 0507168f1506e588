from paddle_tpu_torch.distributed.auto_tuner.tuner import (  # noqa: F401
    AutoTuner, TunerConfig, candidate_configs, compiled_trial_fn,
    prune_candidates)
