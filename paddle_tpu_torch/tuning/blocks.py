"""Shared block-shape resolution for the port's kernels + JSON tuning cache
(``paddle_tpu.tuning.blocks`` counterpart).

Every kernel wrapper of ``ops/cuda`` (and the serving engine's page size)
resolves its block parameters through ONE function, `resolve_blocks`,
with the JAX package's precedence:

    autotuner trial  >  explicit FLAGS override  >  tuning-cache hit  >
    heuristic default

and the chosen provenance recorded per kernel (`last_resolution`), so a
test, or a human staring at a regression, can answer "which block shape
ran, and why" without re-deriving flag state.

The tuning cache is one JSON file (`tuning_cache.json` under
FLAGS_tuning_cache_dir) with schema ``paddle_tpu_torch-tune1``: entries
keyed by (kernel, geometry, dtype, platform). A block value means a Hopper
tile here and a TPU tile in the JAX package's ``paddle_tpu-tune1`` file,
so a file with any other schema, the JAX package's included, is REJECTED
with a re-tune pointer, never read as this package's own. The platform in
the key is the card's name (``torch.cuda.get_device_name``) on CUDA and
``cpu`` otherwise: a tile tuned on one card is not used on another.
FLAGS_autotune selects the mode: ``off`` (default; flags and heuristics
only), ``load`` (consult the cache, heuristic on a miss), ``search`` (on a
miss, time the legal lattice now through ``tuning.autotune``, persist the
winner, use it).

Trial and search state is thread-local. A caller whose later work runs on
another thread (an autograd Function, whose CUDA backward runs on
PyTorch's device thread) resolves once and carries the values along.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = ["KERNELS", "KernelBlocks", "Resolution", "resolve_blocks",
           "last_resolution", "trial_blocks", "cache_key", "platform_of",
           "TuningCache", "TUNING_SCHEMA", "tuning_counters",
           "bump_counter"]

TUNING_SCHEMA = "paddle_tpu_torch-tune1"


@dataclass(frozen=True)
class KernelBlocks:
    """One kernel's tunable block parameters and the flags that override
    them. `auto` is each flag's means-unset sentinel (0 for the 0=auto
    knobs); None means the flag's default is a REAL value (e.g.
    serving_page_size=16) and an override is detected by explicit-set
    tracking (`flags.flag_explicit`) instead. A flag of None means the
    parameter has no override flag in the port: it fills from the tier
    below the flags. An entry with no flag at all is a kernel compiled for
    one block shape: it resolves to its default, with no cache or search."""

    params: tuple
    flags: tuple
    auto: tuple

    @property
    def tunable(self) -> bool:
        return any(f is not None for f in self.flags)


# Six entries for the five kernel families (flash forward and backward tile
# apart), with the JAX package's names. The flash kernels are compiled for
# one tile each until they are templated on tiles (q x k on the tensor
# cores for bf16: forward 64 x 64 at head_dim 128 and 128 x 64 at 64,
# backward 64 x 64; the fp32 CUDA-core kernels stream 32-row tiles past a
# 64-row one), so they have no override flag and nothing to tune.
# fused_ce.chunk_vocab has no flag: the port has only the token-chunked
# fused CE, which reads no vocab chunk.
KERNELS: dict[str, KernelBlocks] = {
    "flash_fwd": KernelBlocks(("block_q", "block_k"), (None, None), (0, 0)),
    "flash_bwd": KernelBlocks(("block_q", "block_k"), (None, None), (0, 0)),
    "grouped_matmul": KernelBlocks(
        ("block_rows",), ("moe_block_rows",), (0,)),
    "fused_ce": KernelBlocks(
        ("chunk_tokens", "chunk_vocab"), ("fused_ce_chunk_tokens", None),
        (0, 0)),
    "rmsnorm": KernelBlocks(
        ("block_rows",), ("rmsnorm_block_rows",), (0,)),
    "paged_attention": KernelBlocks(
        ("page_size",), ("serving_page_size",), (None,)),
}


@dataclass(frozen=True)
class Resolution:
    """What ran and why: `values` maps the kernel's param names to the
    chosen ints; `provenance` is one of flag|tuned|default|trial;
    `source` is the human detail ('FLAGS_rmsnorm_block_rows', the cache
    key, 'heuristic', ...)."""

    kernel: str
    values: dict
    provenance: str
    source: str

    def as_tuple(self) -> tuple:
        return tuple(self.values[p] for p in KERNELS[self.kernel].params)


_STATE = threading.local()
_last: dict[str, Resolution] = {}
_counters_lock = threading.Lock()
_counters = {
    "resolutions_flag": 0, "resolutions_tuned": 0,
    "resolutions_default": 0, "resolutions_trial": 0,
    "autotune_trials": 0, "tuning_cache_rejects": 0,
}
_warned_once: set = set()


def bump_counter(name: str, n: int = 1):
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def tuning_counters() -> dict:
    with _counters_lock:
        return dict(_counters)


def _warn_once(key: str, msg: str):
    if key in _warned_once:
        return
    _warned_once.add(key)
    warnings.warn(msg)


def last_resolution(kernel: str) -> Resolution | None:
    """The most recent Resolution recorded for `kernel` in this process."""
    return _last.get(kernel)


@contextmanager
def trial_blocks(kernel: str, values: dict):
    """Force `kernel` to resolve to `values` with provenance 'trial' on
    this thread: how the autotuner times a candidate through the kernel's
    real public entry point."""
    trials = getattr(_STATE, "trial", None)
    if trials is None:
        trials = _STATE.trial = {}
    prev = trials.get(kernel)
    trials[kernel] = dict(values)
    try:
        yield
    finally:
        if prev is None:
            trials.pop(kernel, None)
        else:
            trials[kernel] = prev


def _device(device=None):
    import torch

    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def platform_of(device=None) -> str:
    """The cache key's platform: the card's name on a CUDA device, "cpu"
    otherwise; `device` None is CUDA when it is available."""
    import torch

    dev = _device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def cache_key(kernel: str, geometry: dict, dtype: str = "",
              platform: str | None = None) -> str:
    """Tuning-cache key: kernel | canonical geometry | dtype | platform."""
    if kernel not in KERNELS:
        raise KeyError(f"unknown kernel {kernel!r}")
    geom = ",".join(f"{k}={geometry[k]}" for k in sorted(geometry))
    return "|".join([kernel, geom, str(dtype or ""),
                     platform or platform_of()])


def _versions() -> dict:
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda}


# ---------------------------------------------------------------------------
# tuning cache (JSON, schema paddle_tpu_torch-tune1)
# ---------------------------------------------------------------------------


class TuningCache:
    """The JSON block-shape cache. One file per directory
    (`tuning_cache.json`); entries are {cache_key: {"values": {...},
    "ms": best_trial_ms, "trials": n, "torch": version, "cuda": version}}.
    Loading a file with another schema raises with a re-tune pointer;
    dispatch-time callers catch that, warn once, and fall through to the
    heuristic default."""

    FILENAME = "tuning_cache.json"

    def __init__(self, cache_dir: str):
        self.dir = str(cache_dir)
        self.path = os.path.join(self.dir, self.FILENAME)
        self.entries: dict[str, dict] = {}

    @classmethod
    def load(cls, cache_dir: str) -> "TuningCache":
        self = cls(cache_dir)
        if not os.path.exists(self.path):
            return self
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                blob = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise ValueError(
                f"{self.path!r}: unreadable tuning cache ({e}); delete the "
                f"file and re-run the autotuner (FLAGS_autotune=search) to "
                f"regenerate it") from e
        fmt = blob.get("format") if isinstance(blob, dict) else None
        if fmt != TUNING_SCHEMA:
            raise ValueError(
                f"{self.path!r}: unsupported tuning-cache format {fmt!r}; "
                f"expected {TUNING_SCHEMA!r} — entries of another schema "
                f"are never reinterpreted (a block value means another "
                f"tile there); delete the file and re-run the autotuner "
                f"(FLAGS_autotune=search) to re-tune")
        self.entries = dict(blob.get("entries", {}))
        return self

    def lookup(self, key: str) -> dict | None:
        e = self.entries.get(key)
        if not isinstance(e, dict) or "values" not in e:
            return None
        return {k: int(v) for k, v in e["values"].items()}

    def store(self, key: str, values: dict, ms: float | None = None,
              trials: int = 0):
        self.entries[key] = {
            "values": {k: int(v) for k, v in values.items()},
            "ms": None if ms is None else round(float(ms), 4),
            "trials": int(trials), **_versions()}
        self.save()

    def save(self):
        os.makedirs(self.dir, exist_ok=True)
        blob = {"format": TUNING_SCHEMA, **_versions(),
                "entries": self.entries}
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


_cache_memo: dict[str, tuple[float, TuningCache]] = {}
_cache_lock = threading.Lock()


def _cache_for(cache_dir: str) -> TuningCache | None:
    """mtime-checked per-directory cache instance; a rejected file
    degrades to 'no cache' with a one-time warning (dispatch must never
    crash on a bad cache file)."""
    try:
        mtime = os.stat(os.path.join(cache_dir,
                                     TuningCache.FILENAME)).st_mtime
    except OSError:
        mtime = -1.0
    with _cache_lock:
        hit = _cache_memo.get(cache_dir)
        if hit is not None and hit[0] == mtime:
            return hit[1]
    try:
        cache = TuningCache.load(cache_dir)
    except ValueError as e:
        bump_counter("tuning_cache_rejects")
        _warn_once(f"tune-reject:{cache_dir}", str(e))
        from paddle_tpu_torch.observability import events as _events

        _events.emit("tuning", "cache_reject", severity="warn",
                     dir=cache_dir, error=str(e)[:200])
        cache = None
    with _cache_lock:
        _cache_memo[cache_dir] = (mtime, cache)
    return cache


# ---------------------------------------------------------------------------
# the resolver
# ---------------------------------------------------------------------------


def _flag_overrides(spec: KernelBlocks):
    """([(param, value or None)], n_set): which override flags the user
    set."""
    from paddle_tpu_torch.core.flags import flag, flag_explicit

    out, n_set = [], 0
    for p, f, auto in zip(spec.params, spec.flags, spec.auto):
        v = None if f is None else flag(f)
        is_set = f is not None and (flag_explicit(f) if auto is None
                                    else v != auto)
        out.append((p, int(v) if is_set else None))
        n_set += bool(is_set)
    return out, n_set


def _record(res: Resolution) -> Resolution:
    _last[res.kernel] = res
    bump_counter(f"resolutions_{res.provenance}")
    return res


def resolve_blocks(kernel: str, geometry: dict, *, dtype: str = "",
                   default=None, validate=None, device=None) -> Resolution:
    """Resolve `kernel`'s block parameters for `geometry`.

    `default` maps geometry -> dict (or tuple in param order) and supplies
    the heuristic tier; `validate(values, geometry)` may raise ValueError:
    a flag override that fails validation propagates (the caller's error
    contract), a tuned entry that fails it degrades to the default with a
    one-time warning. A param whose flag is unset, or which has no flag,
    fills from the tier below the flags (fused_ce's chunk_vocab). `device`
    is where the kernel runs: it names the cache key's platform and is
    where a dispatch-time search times the candidates (None: CUDA when
    available, else the CPU)."""
    spec = KERNELS[kernel]

    trials = getattr(_STATE, "trial", None)
    if trials and kernel in trials:
        return _record(Resolution(kernel, dict(trials[kernel]), "trial",
                                  "autotune trial override"))
    if not spec.tunable:
        return _record(Resolution(kernel, _default_values(kernel, geometry,
                                                          default),
                                  "default", "compiled block shape"))

    overrides, n_set = _flag_overrides(spec)
    if n_set == 0:
        return _resolve_below_flags(kernel, spec, geometry, dtype, default,
                                    validate, device)
    if n_set == len(spec.params):
        values = {p: v for p, v in overrides}
    else:
        below = _resolve_below_flags(kernel, spec, geometry, dtype, default,
                                     validate, device)
        values = {p: (v if v is not None else below.values[p])
                  for p, v in overrides}
    if validate is not None:
        validate(values, geometry)
    return _record(Resolution(
        kernel, values, "flag",
        " and ".join(f"FLAGS_{f}" for (_, v), f in zip(overrides, spec.flags)
                     if v is not None)))


def _default_values(kernel, geometry, default) -> dict:
    d = default(geometry) if callable(default) else default
    if d is None:
        raise ValueError(f"{kernel}: no default block heuristic supplied "
                         f"and no flag/tuned value available")
    if not isinstance(d, dict):
        d = dict(zip(KERNELS[kernel].params, d))
    return {p: int(v) for p, v in d.items()}


def _resolve_below_flags(kernel, spec, geometry, dtype, default, validate,
                         device):
    from paddle_tpu_torch.core.flags import flag

    mode = str(flag("autotune"))
    if mode not in ("off", "load", "search"):
        _warn_once(f"autotune-mode:{mode}",
                   f"FLAGS_autotune={mode!r} is not one of off|load|search; "
                   f"treating as 'off'")
        mode = "off"
    cache_dir = str(flag("tuning_cache_dir"))
    if mode != "off" and cache_dir:
        dev = _device(device)
        key = cache_key(kernel, geometry, dtype, platform_of(dev))
        cache = _cache_for(cache_dir)
        tuned = cache.lookup(key) if cache is not None else None
        if tuned is not None and set(tuned) == set(spec.params):
            try:
                if validate is not None:
                    validate(tuned, geometry)
            except ValueError as e:
                _warn_once(f"tuned-invalid:{key}",
                           f"{kernel}: tuned blocks {tuned} from {key!r} "
                           f"fail validation ({e}); falling back to the "
                           f"heuristic default — re-tune with "
                           f"FLAGS_autotune=search")
            else:
                return _record(Resolution(kernel, tuned, "tuned", key))
        if mode == "search" and cache is not None:
            searching = getattr(_STATE, "searching", None)
            if searching is None:
                searching = _STATE.searching = set()
            if kernel not in searching:
                searching.add(kernel)
                try:
                    from paddle_tpu_torch.tuning.autotune import \
                        autotune_kernel

                    won = autotune_kernel(kernel, geometry, dtype=dtype,
                                          cache=cache, device=dev)
                    if won is not None:
                        return _record(Resolution(kernel, won["values"],
                                                  "tuned", key))
                except Exception as e:  # search must never break dispatch
                    _warn_once(f"search-fail:{key}",
                               f"{kernel}: autotune search failed ({e}); "
                               f"falling back to the heuristic default")
                finally:
                    searching.discard(kernel)

    return _record(Resolution(kernel, _default_values(kernel, geometry,
                                                      default),
                              "default", "heuristic"))
