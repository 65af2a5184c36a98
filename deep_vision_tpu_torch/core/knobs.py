"""Typed environment knobs, the port's copy of the part of
deep_vision_tpu/core/knobs.py that its slices read.

A knob is read through its typed helper, and a value that does not parse
as its type raises `KnobError` instead of running the default: a routing
knob must never no-op on a typo. The port reads the flash attention routing floor
(`DVT_FLASH_MIN_TOKENS`, knobs.py:113), the fault-injection spec and
seed that spawned data workers inherit (`DVT_FAULT_SPEC`,
`DVT_FAULT_SEED`, resilience/faults.py), the lock sanitizer's switch
and thresholds (`DVT_LOCKSMITH`, `DVT_LOCKSMITH_HOLD_MS`,
`DVT_LOCKSMITH_WAIT_MS`, knobs.py:123-131, obs/locksmith.py), the
rendezvous generation a re-entering member attaches to
(`DVT_RDZV_GENERATION`, knobs.py:142, resilience/rendezvous.py), the
live telemetry port the training CLI binds when --telemetry-port is
absent (`DVT_TELEMETRY`, knobs.py:145, obs/telemetry.py), the
front door's default deadline and Retry-After hint
(`DVT_TRANSPORT_DEADLINE_MS`, `DVT_TRANSPORT_RETRY_AFTER_MS`,
knobs.py:148-155, serve/transport.py), the executable cache's directory
(`DVT_EXCACHE`, core/excache.py), which the training CLI reads when
--executable-cache is absent, and its own `DVT_DETERMINISTIC`, which
the training CLI reads.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional


class KnobError(ValueError):
    """An environment knob holds a value its type does not accept."""


class Knob(NamedTuple):
    name: str
    kind: str
    default: object
    doc: str


KNOBS = {k.name: k for k in (
    Knob("DVT_FLASH_MIN_TOKENS", "int", 1024,
         "Flash-attention routing floor: sequences of at least this many "
         "tokens route onto the flash kernels (ops/cuda/"
         "flash_attention.py); lower routes shorter sequences onto them."),
    Knob("DVT_FAULT_SPEC", "str", None,
         "Fault-injection spec (resilience/faults.py grammar); exported by "
         "install_spec so spawned data workers inherit it."),
    Knob("DVT_FAULT_SEED", "int", 0,
         "Seed for probabilistic fault rules (same seed, same sequence)."),
    Knob("DVT_DETERMINISTIC", "int", 0,
         "1: train_cli runs under torch.use_deterministic_algorithms(True) "
         "with cudnn.benchmark off and CUBLAS_WORKSPACE_CONFIG=:4096:8 "
         "(set before CUDA starts), so a run repeats bitwise."),
    Knob("DVT_LOCKSMITH", "flag", False,
         "Arm the locksmith runtime lock-order sanitizer "
         "(obs/locksmith.py) at train_cli start-up."),
    Knob("DVT_LOCKSMITH_HOLD_MS", "float", 1000.0,
         "Locksmith hold-time outlier threshold in milliseconds; holds "
         "past this emit a typed lock_contention event."),
    Knob("DVT_LOCKSMITH_WAIT_MS", "float", 1000.0,
         "Locksmith acquire-wait outlier threshold in milliseconds."),
    Knob("DVT_RDZV_GENERATION", "int", None,
         "Rendezvous generation to re-attach to (resilience/"
         "rendezvous.py) when attach() is given none."),
    Knob("DVT_TELEMETRY", "int", None,
         "Telemetry HTTP port used when --telemetry-port is absent; "
         "0 binds a free port."),
    Knob("DVT_TRANSPORT_DEADLINE_MS", "float", 0.0,
         "Default request deadline (milliseconds) the serving front door "
         "(serve/transport.py) applies to requests that carry no "
         "X-DVT-Deadline-Ms header; 0 means no default deadline."),
    Knob("DVT_EXCACHE", "str", None,
         "Executable cache directory (core/excache.py) the training CLI "
         "attaches when --executable-cache is absent: the compiled "
         "libraries load from it, and a miss is compiled into it."),
    Knob("DVT_TRANSPORT_RETRY_AFTER_MS", "float", 50.0,
         "Retry-After hint (milliseconds) the front door attaches to 429/"
         "503 responses; the loadgen socket client waits at least this "
         "before retrying."),
)}

_TRUE = ("1", "true", "on", "yes")
_FALSE = ("0", "false", "off", "no")

_UNSET = object()


def _lookup(name: str, kind: str) -> Knob:
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a registered knob (core/knobs.py)")
    if knob.kind != kind:
        raise TypeError(f"{name} is a {knob.kind} knob, read as {kind}")
    return knob


def get_int(name: str, default=_UNSET) -> Optional[int]:
    """The knob as an int; unset or blank -> `default` (the registered
    default when not given); anything else that is not an int raises."""
    knob = _lookup(name, "int")
    v = os.environ.get(name)
    if v is None or not v.strip():
        return knob.default if default is _UNSET else default
    try:
        return int(v)
    except ValueError:
        raise KnobError(
            f"{name}={v!r} is not an integer — {knob.doc}") from None


def get_str(name: str, default=_UNSET) -> Optional[str]:
    """The knob as a string; unset or blank -> `default` (the registered
    default when not given)."""
    knob = _lookup(name, "str")
    v = os.environ.get(name)
    if v is None or not v.strip():
        return knob.default if default is _UNSET else default
    return v


def get_float(name: str, default=_UNSET) -> Optional[float]:
    """The knob as a float; unset or blank -> `default` (the registered
    default when not given); anything else that is not a number raises."""
    knob = _lookup(name, "float")
    v = os.environ.get(name)
    if v is None or not v.strip():
        return knob.default if default is _UNSET else default
    try:
        return float(v)
    except ValueError:
        raise KnobError(
            f"{name}={v!r} is not a number — {knob.doc}") from None


def get_flag(name: str, default=_UNSET) -> Optional[bool]:
    """The knob as a bool: 1/true/on/yes or 0/false/off/no, any case;
    unset or blank -> `default`; any other value raises."""
    knob = _lookup(name, "flag")
    v = os.environ.get(name)
    if v is None or not v.strip():
        return knob.default if default is _UNSET else default
    low = v.strip().lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise KnobError(
        f"{name}={v!r} is not a flag value "
        f"({'/'.join(_TRUE)} or {'/'.join(_FALSE)}) — {knob.doc}")
