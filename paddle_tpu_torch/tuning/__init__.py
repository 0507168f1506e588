"""paddle_tpu_torch.tuning: block-size resolution and autotuning of the
port's kernels (``paddle_tpu.tuning`` counterpart).

* `blocks.resolve_blocks`: the ONE resolution helper every kernel's block
  parameters go through (autotuner trial > explicit FLAGS override >
  tuning-cache hit > heuristic default), provenance recorded.
* `autotune`: searches each kernel's legal block lattice by timing real
  launches through the kernel's public entry point; winners persist in the
  JSON tuning cache (FLAGS_tuning_cache_dir, FLAGS_autotune=load|search).

The JAX package's persistent program cache (``program_cache.py``) has no
counterpart yet: the port runs eagerly and compiles no program to cache.

Observability: `tuning_counters()` counts resolutions by provenance,
autotuner trials and rejected cache files; journal events ride component
"tuning" (`autotune`, `autotune_skip`, `cache_reject`). The JAX package's
scrape-time collector into its metrics registry waits for the port's
registry.
"""
from __future__ import annotations

from paddle_tpu_torch.tuning.blocks import (KERNELS, TUNING_SCHEMA,
                                            Resolution, TuningCache,
                                            cache_key, last_resolution,
                                            platform_of, resolve_blocks,
                                            trial_blocks, tuning_counters)

__all__ = ["KERNELS", "Resolution", "TuningCache", "TUNING_SCHEMA",
           "cache_key", "last_resolution", "platform_of", "resolve_blocks",
           "trial_blocks", "tuning_counters"]
