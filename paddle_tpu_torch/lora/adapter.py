"""LoRA adapter definition, frozen-base training and artifact export
(``paddle_tpu.lora.adapter`` counterpart).

A target projection ``y = x W^T`` gains a rank-``r`` update ``y = x W^T +
(alpha / r) * (x @ A) @ B`` with ``A [d_in, r]`` (small random init) and
``B [r, d_out]`` (zeros: attaching is exactly a no-op until training moves
B). The factors keep the JAX package's layout; the base weight is
PyTorch's ``[out, in]``, so a target's ``(d_in, d_out)`` is
``(weight.shape[1], weight.shape[0])``.

`attach()` freezes every base parameter (``requires_grad_(False)``) and
registers A/B with the seam, keyed by ``id(weight)``; the factors also
land on the model as a ``_lora_host`` submodule, which puts them in
``model.parameters()`` (what an optimizer and a `TrainStep` take) after
the base parameters. `export_adapter` writes the ``paddle_tpu-npz1``
container the JAX package writes (factors interleaved ``[A_0, B_0, A_1,
...]`` in target order plus an ``adapter`` meta block), so either package
reads the other's adapters.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.lora import seam

__all__ = ["LoRAConfig", "LoRAAdapter", "attach", "detach",
           "export_adapter", "load_adapter", "find_targets",
           "DEFAULT_TARGETS", "as_tensor"]

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


@dataclass
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = DEFAULT_TARGETS
    dtype: object = None          # None -> each target weight's dtype
    seed: int = 0

    @property
    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)


def _torch_dtype(dtype, default: torch.dtype) -> torch.dtype:
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("torch.", ""))


def as_tensor(a) -> torch.Tensor:
    """A factor as a CPU tensor: tensors (the artifact's small floats, or
    a caller's) detached to the CPU, numpy arrays copied, an ``ml_dtypes``
    small-float array (the JAX package's bf16) through its integer bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.array(a, copy=True)
    from paddle_tpu_torch.inference.artifact import SMALL_FLOATS

    tdt = SMALL_FLOATS.get(arr.dtype.name)
    if tdt is not None:
        carrier = np.uint8 if tdt.itemsize == 1 else np.int16
        return torch.from_numpy(arr.view(carrier)).view(tdt)
    return torch.from_numpy(arr)


def find_targets(model, targets):
    """Deterministic (traversal-order) list of ``(path, weight)`` for every
    submodule whose attribute name matches a target projection and that
    carries a 2-D ``weight`` — the shared discovery of `attach()` and the
    serving `AdapterStore`, so exported factor order lines up with the
    store's pools by construction. The paths are the JAX package's
    (``llama.layers.0.self_attn.q_proj``)."""
    found = []
    seen = set()
    for path, sub in model.named_modules():
        if not path or path.rsplit(".", 1)[-1] not in targets:
            continue
        w = getattr(sub, "weight", None)
        if w is None or w.dim() != 2 or id(w) in seen:
            continue
        seen.add(id(w))
        found.append((path, w))
    if not found:
        raise ValueError(
            f"no LoRA target projections found: none of {tuple(targets)} "
            f"name a submodule with a 2-D weight on {type(model).__name__}")
    return found


def target_dims(w) -> tuple[int, int]:
    """(d_in, d_out) of a projection weight in PyTorch's [out, in]."""
    return int(w.shape[1]), int(w.shape[0])


@dataclass
class LoRAAdapter:
    """Handle returned by `attach()`: the adapted weights and their A/B
    factors, plus what `detach()` needs to restore the model exactly."""
    model: object
    config: LoRAConfig
    entries: list = field(default_factory=list)   # (path, weight, A, B)
    _frozen: list = field(default_factory=list)   # (param, prior requires_grad)
    _attached: bool = True

    def parameters(self):
        out = []
        for _, _, a, b in self.entries:
            out.extend((a, b))
        return out

    def export(self, path: str, adapter_id: str = "adapter"):
        export_adapter(path, self, adapter_id=adapter_id)

    @torch.no_grad()
    def load_weights(self, blob: dict):
        """Overwrite the attached factors from a `load_adapter()` blob
        (rank and targets validated): resume, or carry weights over."""
        meta, weights = blob["adapter"], blob["weights"]
        if int(meta["rank"]) != int(self.config.rank):
            raise ValueError(f"adapter rank {meta['rank']} != attached "
                             f"rank {self.config.rank}")
        for path, _, a, b in self.entries:
            if path not in weights:
                raise ValueError(f"adapter blob is missing factors for "
                                 f"target {path!r}")
            av, bv = (as_tensor(t) for t in weights[path])
            if tuple(av.shape) != tuple(a.shape) \
                    or tuple(bv.shape) != tuple(b.shape):
                raise ValueError(
                    f"adapter blob target {path!r}: factor shapes "
                    f"{tuple(av.shape)}/{tuple(bv.shape)} do not fit "
                    f"{tuple(a.shape)}/{tuple(b.shape)}")
            a.copy_(av.to(a.dtype))
            b.copy_(bv.to(b.dtype))


def attach(model, config: LoRAConfig | None = None,
           freeze_base: bool = True) -> LoRAAdapter:
    """Attach rank-``r`` factors to every target projection and (by
    default) freeze the base: afterwards ``model.parameters()`` is the
    frozen base plus the trainable A/B factors. A is drawn from a numpy
    generator seeded with ``config.seed`` (as the JAX package draws it),
    B is zero. Detach before serving the base through an
    `AdapterStore`."""
    cfg = config or LoRAConfig()
    if int(cfg.rank) <= 0:
        raise ValueError(f"LoRA rank must be positive, got {cfg.rank}")
    if getattr(model, "mp_group", None) is not None:
        raise NotImplementedError("LoRA under tensor parallelism (mp > 1) "
                                  "is not ported yet (ROADMAP A8)")
    if getattr(model, "_lora_host", None) is not None:
        raise ValueError("model already has a LoRA adapter attached; "
                         "detach() it first")
    handle = LoRAAdapter(model=model, config=cfg)
    if freeze_base:
        for p in model.parameters():
            handle._frozen.append((p, p.requires_grad))
            p.requires_grad_(False)
    rng = np.random.default_rng(cfg.seed)
    host = nn.Module()
    for i, (path, w) in enumerate(find_targets(model, cfg.targets)):
        d_in, d_out = target_dims(w)
        dt = _torch_dtype(cfg.dtype, w.dtype)
        # A: small random (a non-degenerate input projection); B: zeros,
        # so attaching is exactly a no-op at step 0
        a_np = (rng.standard_normal((d_in, cfg.rank))
                * (1.0 / max(cfg.rank, 1)))
        A = nn.Parameter(torch.from_numpy(a_np).to(device=w.device,
                                                   dtype=dt))
        B = nn.Parameter(torch.zeros((cfg.rank, d_out), device=w.device,
                                     dtype=dt))
        host.register_parameter(f"a_{i}", A)
        host.register_parameter(f"b_{i}", B)
        handle.entries.append((path, w, A, B))
        seam.train_register(id(w), seam.TrainEntry(A, B, cfg.scale))
    model._lora_host = host
    model._lora_adapter = handle
    return handle


def detach(handle: LoRAAdapter):
    """Remove the adapter: clear the seam registry, drop the host submodule
    (A/B leave ``model.parameters()``), restore every base parameter's
    prior ``requires_grad``. The model is bit-identical to before the
    attach (W was never written)."""
    if not handle._attached:
        return
    handle._attached = False
    seam.train_clear(id(w) for _, w, _, _ in handle.entries)
    model = handle.model
    if getattr(model, "_lora_host", None) is not None:
        del model._lora_host
    model.__dict__.pop("_lora_adapter", None)
    for p, prior in handle._frozen:
        p.requires_grad_(prior)


def export_adapter(path: str, handle: LoRAAdapter,
                   adapter_id: str = "adapter"):
    """Write the adapter as a ``paddle_tpu-npz1`` artifact: params are the
    interleaved ``[A_0, B_0, A_1, B_1, ...]`` factors in target order and
    meta carries the ``adapter`` block (id, rank, alpha, targets, target
    paths) — everything `AdapterStore.register()` needs. Raises when every
    B is zero (the attach-time state: a no-op adapter)."""
    cfg = handle.config
    params, names = [], []
    for pth, _, a, b in handle.entries:
        params.append(a.detach().cpu())
        params.append(b.detach().cpu())
        names.append(pth)
    if all(not torch.any(params[i] != 0) for i in range(1, len(params), 2)):
        raise ValueError(
            "export_adapter: every B factor is zero (the attach-time "
            "init), so this adapter is a no-op; train it (or set B) "
            "before exporting.")
    from paddle_tpu_torch.inference.artifact import write_artifact

    write_artifact(path, {
        "params": params,
        "class_name": type(handle.model).__name__,
        "adapter": {
            "id": str(adapter_id),
            "rank": int(cfg.rank),
            "alpha": float(cfg.alpha),
            "targets": list(cfg.targets),
            "names": names,
        },
    })


def load_adapter(path: str) -> dict:
    """Read an adapter artifact (either package's): ``{"adapter": meta,
    "weights": {target_path: (A, B)}}``, the factors as numpy arrays (CPU
    torch tensors for bf16). Rejects containers without the ``adapter``
    meta block."""
    from paddle_tpu_torch.inference.artifact import read_artifact

    blob = read_artifact(path)
    meta = blob.get("adapter")
    if not meta:
        raise ValueError(f"{path!r} is not a LoRA adapter artifact "
                         f"(no 'adapter' meta block)")
    names = list(meta.get("names", ()))
    params = blob.get("params", [])
    if len(params) != 2 * len(names):
        raise ValueError(
            f"{path!r}: adapter artifact has {len(params)} factor arrays "
            f"for {len(names)} targets (expected exactly A+B per target)")
    weights = {n: (params[2 * i], params[2 * i + 1])
               for i, n in enumerate(names)}
    return {"adapter": meta, "weights": weights}
