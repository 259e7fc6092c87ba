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
    # Lazy-SMP lanes per analysed position (1 disables helpers)
    "FISHNET_TPU_HELPERS": "4",
    # per-dispatch lane ceiling
    "FISHNET_TPU_MAX_LANES": "1024",
    # continuous lane refill: single-pv analysis through the LaneScheduler
    "FISHNET_TPU_REFILL": "1",
    # the same on a meshed engine (0: its chunks take the chunk-serial
    # sharded path; no effect without a mesh or with FISHNET_TPU_REFILL=0)
    "FISHNET_TPU_MESH_REFILL": "1",
    # the streaming loops' pipelined boundary (0: the synchronous loop)
    "FISHNET_TPU_PIPELINE": "1",
    "FISHNET_TPU_SEGMENT": "20000",
    # bounds of FISHNET_TPU_SEGMENT=auto (the lower one is its start)
    "FISHNET_TPU_SEGMENT_MIN": "2048",
    "FISHNET_TPU_SEGMENT_MAX": "65536",
    "FISHNET_TPU_NARROW_FLOOR": "64",
    "FISHNET_TPU_NO_PRUNING": "0",
    "FISHNET_TPU_ASPIRATION": "",
    # weight quantization: "int8" (with the flag below; board768 nets
    # only) or "bf16"/"bfloat16" (board768 and king-bucketed nets stored
    # in bf16, f32 arithmetic)
    "FISHNET_TPU_DTYPE": "",
    "FISHNET_TPU_EXPERIMENTAL_INT8": "0",
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
    """FISHNET_TPU_SEGMENT: device steps per segment, or None for "auto".
    Under "auto" the streaming loops (ops/search.py search_stream, the
    engine's LaneScheduler) tune the length with syncstats.SegmentController
    within FISHNET_TPU_SEGMENT_MIN/_MAX; the batch path
    (search_batch_resumable) takes FISHNET_TPU_SEGMENT_MAX."""
    value = raw("FISHNET_TPU_SEGMENT").strip().lower()
    return None if value == "auto" else int(value)


def get_csv_int(name: str) -> Optional[Tuple[int, ...]]:
    value = raw(name)
    if value is None:
        return None
    return tuple(int(x) for x in value.split(",") if x)
