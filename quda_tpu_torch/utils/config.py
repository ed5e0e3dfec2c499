"""Environment knobs, as in quda_tpu/utils/config.py, with the
``QUDA_TORCH_`` prefix.

Every knob the port reads is registered here with its type, default and
doc string, and read through ``get``, which validates the value.  Only
the knobs a ported route reads are registered: the three of
``invert_multi_src_quda`` (quda_tpu/utils/config.py:308-325) and the two
of the tuner (utils/tune.py; quda_tpu/utils/config.py:74-79).  Values are
read from the environment at each call, so a change takes effect at the
next solve.
"""

from __future__ import annotations

import dataclasses
import os

_PREFIX = "QUDA_TORCH_"


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str                 # full environment variable name
    kind: str                 # "bool" | "int" | "str" | "choice"
    default: object
    doc: str
    choices: tuple = ()
    reference: str = ""       # the reference knob this replaces


_REGISTRY: dict = {}


def _register(name, kind, default, doc, choices=(), reference=""):
    assert name.startswith(_PREFIX), name
    _REGISTRY[name] = Knob(name, kind, default, doc, tuple(choices),
                           reference)


_register("QUDA_TORCH_MAX_MULTI_RHS", "int", 32,
          "advisory cap on simultaneously batched right-hand sides: a "
          "larger batch warns (device memory may not hold it) and runs",
          reference="QUDA_MAX_MULTI_RHS")
_register("QUDA_TORCH_MULTI_SRC_SPLIT", "choice", "",
          "invert_multi_src_quda routing: '1' = force the split-grid "
          "route (multi-device, ROADMAP A15: raises until then), '0' = "
          "forbid it, empty = auto (split when more than one device "
          "divides the batch; never, until A15)",
          ("", "0", "1"),
          reference="callMultiSrcQuda split_key "
                    "(lib/interface_quda.cpp:3064)")
_register("QUDA_TORCH_MULTI_SRC_BLOCK", "choice", "",
          "batched multi-source solver: '1' = true block CG (one shared "
          "Krylov space, real Gram matmuls), empty = independent per-RHS "
          "lanes (batched CG), QUDA's per-source multi-RHS solves",
          ("", "1"),
          reference="QUDA block-CG solver family (inv_cg_quda.cpp block "
                    "variants)")


_register("QUDA_TORCH_ENABLE_TUNING", "bool", True,
          "enable the implementation-choice autotuner (utils/tune.py); "
          "off, tune() returns the first candidate without timing",
          reference="QUDA_ENABLE_TUNING")
_register("QUDA_TORCH_RESOURCE_PATH", "str", "",
          "directory of the tuner's tunecache.json and profile output; "
          "empty = nothing is written or read",
          reference="QUDA_RESOURCE_PATH")


def _parse(knob: Knob, raw: str):
    if knob.kind == "bool":
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{knob.name}={raw!r}: expected a boolean (0/1)")
    if knob.kind == "str":
        return raw
    if knob.kind == "int":
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"{knob.name}={raw!r}: expected an integer") \
                from None
    if raw not in knob.choices:
        raise ValueError(f"{knob.name}={raw!r}: expected one of "
                         f"{knob.choices}")
    return raw


def get(name: str):
    """Typed value of a registered knob: the environment's, or the
    default when it is unset or empty."""
    if name not in _REGISTRY:
        raise KeyError(f"unregistered config knob {name!r}; known: "
                       f"{sorted(_REGISTRY)}")
    knob = _REGISTRY[name]
    raw = os.environ.get(name)
    return knob.default if raw is None or raw == "" else _parse(knob, raw)
