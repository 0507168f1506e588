"""DistributedStrategy (``paddle_tpu.distributed.fleet.base.
distributed_strategy`` counterpart; reference: fleet/base/
distributed_strategy.py, backed by framework/distributed_strategy.proto).
A plain-Python configuration: ``hybrid_configs`` (the dp, mp, pp,
sharding and sep degrees) and the toggles the port honours (amp,
recompute, gradient_merge, sharding with ``sharding_configs["stage"]`` 1
or 2, the data-parallel bucket sizes)."""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _HybridConfig(dict):
    DEFAULTS = {
        "dp_degree": 1,
        "mp_degree": 1,
        "pp_degree": 1,
        "sharding_degree": 1,
        "sep_degree": 1,
        "ep_degree": 1,
        "order": ["pipe", "data", "sharding", "sep", "model"],
        "mp_configs": {},
        "pp_configs": {},
    }

    def __init__(self, *a, **k):
        super().__init__(self.DEFAULTS)
        self.update(*a, **k)


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = _HybridConfig()
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_fp16": False,
                            "custom_white_list": [], "custom_black_list": [], "dtype": "bfloat16"}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 1, "offload": False,
                                 "comm_overlap": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "compile": True, "schedule_mode": "1F1B",
                                 "p2p_cache_shape": True,
                                 "enable_partial_send_recv": True}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        # cap of the FIRST grad bucket (reference last_comm_group_size_MB):
        # small so its collective posts early in backward
        self.last_comm_group_size_MB = 1
        self.without_graph_optimization = False
        self.a_sync = False
        # everything set above is the honored surface; later unknown sets warn
        # (reference validates via protobuf, distributed_strategy.py:1765)
        object.__setattr__(self, "_known", set(self.__dict__))

    @property
    def hybrid_configs_dict(self):
        return dict(self.hybrid_configs)

    # -- serialization (reference strategy proto save/load parity) -----------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            if k.startswith("_"):  # internal state is not strategy surface
                continue
            out[k] = dict(v) if isinstance(v, dict) else v
        return out

    def from_dict(self, d: dict):
        for k, v in d.items():
            if k.startswith("_"):
                continue
            setattr(self, k, v)
        return self

    def save_to_prototxt(self, path):
        """reference save_to_prototxt: persisted as JSON (no proto dep)."""
        import json

        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    def load_from_prototxt(self, path):
        import json

        with open(path) as f:
            return self.from_dict(json.load(f))

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and isinstance(v, dict) and not isinstance(v, _HybridConfig):
            cfg = _HybridConfig()
            cfg.update(v)
            object.__setattr__(self, k, cfg)
            return
        known = self.__dict__.get("_known")
        if known is not None and not k.startswith("_") and k not in known:
            import warnings

            warnings.warn(
                f"DistributedStrategy: unknown option {k!r} is stored but has "
                "no effect in this build (the honored subset is "
                f"{sorted(x for x in known if not x.startswith('_'))})",
                stacklevel=2)
        elif (known is not None and k in known and k.endswith("_configs")
                and isinstance(v, dict)):
            cur = self.__dict__.get(k)
            if isinstance(cur, dict):
                bad = set(v) - set(cur)
                if bad:
                    import warnings

                    warnings.warn(
                        f"DistributedStrategy.{k}: unknown keys {sorted(bad)} "
                        f"are stored but ignored (known: {sorted(cur)})",
                        stacklevel=2)
                merged = dict(cur)
                merged.update(v)
                v = merged
        object.__setattr__(self, k, v)

    def __repr__(self):
        return f"DistributedStrategy(hybrid_configs={dict(self.hybrid_configs)})"
