"""Autotuner with a persistent, hardware-keyed on-disk cache.

Port of quda_tpu/utils/tune.py (QUDA's lib/tune.cpp: every tunable kernel
times its candidates once, caches the winner in
$QUDA_RESOURCE_PATH/tunecache keyed by {volume, name, aux}, and doubles as
the profiling system).  What is tunable here is the choice among whole
implementations of one function (the Wilson dslash: the complex stencil,
the packed pair stencil, the B4 and B10 kernels; ``ops/wilson_pallas.
tuned_dslash``).  ``tune`` calls each candidate once (warm-up: the first
call on the card builds the kernel library), then takes the minimum over
``reps`` timings of ``inner`` back-to-back calls, each timing closed by
``torch.cuda.synchronize`` when the output lies on the card.  Winners
persist in $QUDA_TORCH_RESOURCE_PATH/tunecache.json (nothing is written
or read while the knob is empty); ``record_launch`` and ``save_profile``
are the profiler half (profile_0.tsv).

Cache key: ``platform|volume|name|aux``, ``platform`` being
:func:`platform_key`: ``cuda:<device name>:n<device count>``, or
``cpu:cpu:n1`` on a host without a card, so a winner raced on one card
is never served on another kind, or on the CPU.  Entries without a
``platform`` field (the JAX package's pre-platform schema) are dropped at
load with a one-time warning.  ``warm_start`` (called by ``init_quda``)
loads the cache under the current resource path.

One deliberate difference from the JAX package: a candidate that raises
is not skipped, and a race whose candidates all raise does not degrade to
the first candidate.  The exception propagates, because a candidate here
is a hand-written kernel, and skipping one that failed to build or launch
is the silent fallback to another implementation that this port does not
allow.  With ``QUDA_TORCH_ENABLE_TUNING=0`` ``tune`` returns the first
candidate untimed, as the JAX package does.

The JAX package mirrors every decision into its observability plane
(trace events, metrics); ``_obs_event``, ``_obs_metric`` and
``_obs_gauge`` are no-ops here until that plane is ported (ROADMAP A17).
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Callable, Dict, Optional

import torch

log = logging.getLogger("quda_tpu_torch")

_cache: Dict[str, dict] = {}
_profile: Dict[str, dict] = {}
_loaded_path: Optional[str] = None
_stale_noticed = False

CACHE_FILE = "tunecache.json"


def _resource_path() -> str:
    from . import config
    return config.get("QUDA_TORCH_RESOURCE_PATH")


def tuning_enabled() -> bool:
    from . import config
    return config.get("QUDA_TORCH_ENABLE_TUNING")


def platform_key() -> str:
    """The hardware this process races on: ``cuda:<device name>:n<count>``
    (``torch.cuda.get_device_name``, ``torch.cuda.device_count``), or
    ``cpu:cpu:n1`` without a card; '|' and whitespace folded to '-'."""
    if torch.cuda.is_available():
        name = re.sub(r"[\s|]+", "-", torch.cuda.get_device_name(0))
        return f"cuda:{name.strip('-')}:n{torch.cuda.device_count()}"
    return "cpu:cpu:n1"


def tune_key(name: str, volume, aux: str = "") -> str:
    """TuneKey {volume, name, aux} with the platform prepended."""
    return f"{platform_key()}|{volume}|{name}|{aux}"


def cached_param(name: str, volume, aux: str = "") -> Optional[str]:
    """The cached winner for (platform, volume, name, aux), or None."""
    e = _cache.get(tune_key(name, volume, aux))
    return e.get("param") if isinstance(e, dict) else None


def _notice_stale(n: int, path: str) -> None:
    global _stale_noticed
    _obs_event("tune_cache_invalidated", count=n, path=path)
    if not _stale_noticed:
        _stale_noticed = True
        log.warning("tunecache %s: dropped %d entr%s recorded without a "
                    "platform key (not attributable to this hardware); "
                    "stale schema, re-racing on first use", path, n,
                    "y" if n == 1 else "ies")


def load_cache() -> Optional[dict]:
    """Load tunecache.json under the current resource path into the
    process cache, dropping entries without a ``platform`` field.
    Returns {'path', 'entries', 'stale'} (None without a resource path)."""
    global _loaded_path
    path = _resource_path()
    if not path:
        return None
    f = os.path.join(path, CACHE_FILE)
    loaded = stale = 0
    if os.path.exists(f):
        try:
            with open(f) as fh:
                raw = json.load(fh)
        except (json.JSONDecodeError, OSError):
            raw = {}
        for k, v in raw.items():
            if isinstance(v, dict) and v.get("platform"):
                _cache[k] = v
                loaded += 1
            else:
                stale += 1
        if stale:
            _notice_stale(stale, f)
    _loaded_path = f
    return {"path": f, "entries": loaded, "stale": stale}


def save_cache() -> None:
    path = _resource_path()
    if not path:
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CACHE_FILE), "w") as fh:
        json.dump(_cache, fh, indent=1, sort_keys=True)


def warm_start() -> int:
    """``init_quda``'s hook: (re)load the persistent cache so the first
    call serves winners raced by earlier processes on this hardware.
    Returns the number of entries usable here."""
    stats = load_cache() or {"path": "", "entries": 0, "stale": 0}
    here = platform_key()
    usable = sum(1 for k in _cache if k.startswith(here + "|"))
    _obs_event("tune_cache_loaded", path=stats["path"], entries=len(_cache),
               usable_here=usable, stale_dropped=stats["stale"],
               platform=here)
    _obs_gauge("tune_cache_entries", usable, scope="usable_here")
    return usable


def cache_snapshot(platform_only: bool = True) -> Dict[str, dict]:
    """A copy of the in-process cache; with ``platform_only`` only the
    entries servable on this hardware."""
    here = platform_key() + "|"
    return {k: dict(v) for k, v in _cache.items()
            if not platform_only or k.startswith(here)}


def _obs_event(name: str, **fields) -> None:
    """Trace event of a tuner decision: a no-op until obs/ is ported."""


def _obs_metric(name: str, value: float = 1.0, **labels) -> None:
    """Counter of the tuner's cache behaviour: a no-op until obs/ is
    ported."""


def _obs_gauge(name: str, value: float, **labels) -> None:
    """Gauge of the tuner's cache: a no-op until obs/ is ported."""


def _sync(out) -> None:
    """Wait for the card when ``out`` (a tensor, or a tuple of them) lies
    on it; CPU results are ready when the call returns."""
    first = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)


def _ensure_loaded() -> None:
    path = _resource_path()
    if path and _loaded_path != os.path.join(path, CACHE_FILE):
        load_cache()


def tune(name: str, volume, candidates: Dict[str, Callable], args: tuple,
         aux: str = "", reps: int = 3, inner: int = 5) -> str:
    """The winning candidate's key: timed once per hardware, cached.

    candidates: {param: callable}, each called as f(*args) and returning
    a tensor.  A cached winner that is still a candidate is returned
    untimed; with tuning off, the first candidate.  Otherwise every
    candidate runs once (warm-up), then ``reps`` timings of ``inner``
    back-to-back calls each; the fastest minimum wins and is cached (and
    saved under the resource path).  A candidate that raises fails the
    race: the exception propagates (module docstring)."""
    _ensure_loaded()
    key = tune_key(name, volume, aux)
    if key in _cache and _cache[key]["param"] in candidates:
        _obs_event("tune_cached", key=key, param=_cache[key]["param"])
        _obs_metric("tune_cache_hits_total", kernel=name)
        return _cache[key]["param"]
    _obs_metric("tune_cache_misses_total", kernel=name)
    if not tuning_enabled():
        return next(iter(candidates))
    _obs_metric("tune_races_total", kernel=name)
    best, best_t = None, float("inf")
    for param, fn in candidates.items():
        _sync(fn(*args))                     # warm-up (and kernel build)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                out = fn(*args)
            _sync(out)
            times.append((time.perf_counter() - t0) / inner)
        t = min(times)
        record_launch(name, volume, f"{aux}|{param}", t)
        _obs_event("tune_candidate", key=key, param=param, seconds=t)
        if t < best_t:
            best, best_t = param, t
    if best is None:
        raise ValueError(f"tune({name!r}): no candidates")
    _cache[key] = {"param": best, "time": best_t, "platform": platform_key()}
    _obs_event("tune_winner", key=key, param=best, seconds=best_t)
    save_cache()
    return best


def record_launch(name: str, volume, aux: str, seconds: float,
                  flops: float = 0.0, bytes_: float = 0.0) -> None:
    """Accumulate per-kernel stats (the profiler half of lib/tune.cpp)."""
    p = _profile.setdefault(tune_key(name, volume, aux),
                            {"calls": 0, "seconds": 0.0, "flops": 0.0,
                             "bytes": 0.0})
    p["calls"] += 1
    p["seconds"] += seconds
    p["flops"] += flops
    p["bytes"] += bytes_


def profile_snapshot() -> Dict[str, dict]:
    """A copy of the accumulated per-key stats (seconds per call of each
    raced candidate among them)."""
    return {k: dict(v) for k, v in _profile.items()}


def save_profile(fname: str = "profile_0.tsv") -> Optional[str]:
    """Write profile_N.tsv as lib/tune.cpp does; returns its path (None
    without a resource path)."""
    path = _resource_path()
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, fname)
    with open(out, "w") as fh:
        fh.write("key\tcalls\tseconds\tGFLOPS\tGB/s\n")
        for key, p in sorted(_profile.items()):
            s = max(p["seconds"], 1e-12)
            fh.write(f"{key}\t{p['calls']}\t{p['seconds']:.6f}\t"
                     f"{p['flops'] / s / 1e9:.2f}\t"
                     f"{p['bytes'] / s / 1e9:.2f}\n")
    return out
