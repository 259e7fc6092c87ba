"""Host-device synchronization accounting for the segment loops (a port
of the JAX package's utils/syncstats.py, without its trace recorder).

Every host-blocking read of a device value in the streaming loops
(ops/search.py search_stream, the engine's LaneScheduler) goes through
SyncStats.fetch, so each segment boundary's cost is counted: transfers,
elements, and the wall-clock the host sat blocked on the device.

The split reported per segment:

  device_ms  the segment's time on the device: the wall-clock of the
             segment call itself (device_call) plus the time the host
             sat blocked inside fetch();
  host_ms    the rest of the boundary interval: scheduling, refill
             staging, result bookkeeping.

The reference dispatches a segment asynchronously and then blocks in a
fetch until the device has run it. In this package `run_segment`
returns only once the segment is done (on the card it launches the
segment kernel K11 and reads its step count), so the loops run it through
device_call and its wall-clock is the segment's device time; a fetch
alone would see almost none of it, and FISHNET_TPU_SEGMENT=auto would
then read every boundary as host-bound.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


class SyncStats:
    """Per-segment transfer and blocked-time accounting; boundary()
    closes the current segment's window and returns its snapshot."""

    def __init__(self) -> None:
        self.transfers_total = 0
        self.elements_total = 0
        self.blocked_ms_total = 0.0
        self.segments_total = 0
        self._seg_transfers = 0
        self._seg_elements = 0
        self._seg_blocked_ms = 0.0
        self._seg_device_ms = 0.0
        self._seg_start = time.monotonic()

    def fetch(self, value, label: str = "") -> np.ndarray:
        """A tensor (or array-like) as a host numpy array, counting one
        transfer and the wall-clock spent blocked."""
        t0 = time.monotonic()
        arr = value.cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        dt_ms = (time.monotonic() - t0) * 1000.0
        self._seg_transfers += 1
        self._seg_elements += int(arr.size)
        self._seg_blocked_ms += dt_ms
        self.transfers_total += 1
        self.elements_total += int(arr.size)
        self.blocked_ms_total += dt_ms
        return arr

    def count(self, arr: np.ndarray, transfers: int = 1) -> np.ndarray:
        """Count `transfers` reads that brought the host array `arr` over
        outside fetch: parallel/mesh.py run_segment_sharded reads its
        stacked summary itself, one copy a distinct device, inside the
        segment call's device time; the loops count it where they use it,
        as the reference counts its fetch. Returns arr."""
        self._seg_transfers += transfers
        self._seg_elements += int(arr.size)
        self.transfers_total += transfers
        self.elements_total += int(arr.size)
        return arr

    def device_call(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) for a call that returns only once the
        device has finished the work it launched (run_segment), counting
        its wall-clock as device time."""
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        dt_ms = (time.monotonic() - t0) * 1000.0
        self._seg_device_ms += dt_ms
        return out

    def boundary(self) -> dict:
        """{"transfers", "elements", "device_ms", "host_ms"} for the
        interval since the previous boundary() (or construction)."""
        now = time.monotonic()
        wall_ms = (now - self._seg_start) * 1000.0
        device_ms = self._seg_blocked_ms + self._seg_device_ms
        snap = {
            "transfers": self._seg_transfers,
            "elements": self._seg_elements,
            "device_ms": round(device_ms, 3),
            "host_ms": round(max(wall_ms - device_ms, 0.0), 3),
        }
        self.segments_total += 1
        self._seg_transfers = 0
        self._seg_elements = 0
        self._seg_blocked_ms = 0.0
        self._seg_device_ms = 0.0
        self._seg_start = now
        return snap


class SegmentController:
    """Measured-feedback segment-length tuner (FISHNET_TPU_SEGMENT=auto).

    Holds the boundary-cost share host_ms / (host_ms + device_ms) inside a
    hysteresis band: doubles the segment length when boundaries dominate,
    halves it when the host is negligible, within [lo, hi], in powers of
    two so the step count revisits the same few values."""

    def __init__(self, lo: int, hi: int, start: Optional[int] = None,
                 low_share: float = 0.02, high_share: float = 0.10) -> None:
        if lo < 1:
            raise ValueError(f"segment lower bound must be >= 1, got {lo}")
        if hi < lo:
            raise ValueError(f"segment bounds inverted: [{lo}, {hi}]")
        self.lo = lo
        self.hi = hi
        self.low_share = low_share
        self.high_share = high_share
        self.steps = min(max(start if start is not None else lo, lo), hi)

    def update(self, ran_full: bool, host_ms: float,
               device_ms: float) -> int:
        """Feed one boundary's measurement; returns the step count for
        the next segment. Segments that ended early (every lane DONE)
        carry no length signal and leave the setting untouched."""
        if not ran_full:
            return self.steps
        total = host_ms + device_ms
        if total <= 0.0:
            return self.steps
        share = host_ms / total
        if share > self.high_share:
            self.steps = min(self.steps * 2, self.hi)
        elif share < self.low_share:
            self.steps = max(self.steps // 2, self.lo)
        return self.steps
