"""The FISHNET_TPU_* knobs this package reads.

Same names, meanings and defaults as the JAX package's registry, so one
environment drives both packages (the tests run them side by side).
Values are read on every call: tests change the environment between
searches.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

_FALSE_WORDS = ("0", "false", "no", "off")

# name → default, in string form ("" = unset)
DEFAULTS = {
    "FISHNET_TPU_MAX_PLY": "32",
    "FISHNET_TPU_SEGMENT": "20000",
    "FISHNET_TPU_SEGMENT_MAX": "65536",
    "FISHNET_TPU_NARROW_FLOOR": "64",
    "FISHNET_TPU_NO_PRUNING": "0",
    "FISHNET_TPU_ASPIRATION": "",
}


def raw(name: str) -> Optional[str]:
    """The environment value, or the default when unset or empty."""
    value = os.environ.get(name) or DEFAULTS[name]
    return value or None


def get_bool(name: str) -> bool:
    value = raw(name)
    return value is not None and value.strip().lower() not in _FALSE_WORDS


def get_int(name: str) -> int:
    return int(raw(name))


def get_segment() -> Optional[int]:
    """FISHNET_TPU_SEGMENT: device steps per segment, or None for "auto"
    (this package has no segment controller: callers then take
    FISHNET_TPU_SEGMENT_MAX)."""
    value = raw("FISHNET_TPU_SEGMENT").strip().lower()
    return None if value == "auto" else int(value)


def get_csv_int(name: str) -> Optional[Tuple[int, ...]]:
    value = raw(name)
    if value is None:
        return None
    return tuple(int(x) for x in value.split(",") if x)
