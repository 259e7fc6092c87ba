"""The engine seam: chunks in, PositionResponses out.

Mirrors the JAX package's engine/base.py and the `go_multiple` shape of
the reference's engine stub (src/stockfish.rs:36-48): the async
`go_multiple` runs the engine's blocking `_go_multiple_sync` in an
executor thread, and any failure other than an EngineError surfaces as
one.
"""
from __future__ import annotations

import asyncio
from typing import List

from ..ipc import Chunk, PositionResponse


class EngineError(Exception):
    """Engine died or misbehaved; the worker drops and respawns it with
    backoff (reference: src/main.rs:330-336)."""


class BatchEngine:
    """Base for engines whose work is a blocking `_go_multiple_sync`."""

    name = "engine"

    def _go_multiple_sync(self, chunk: Chunk) -> List[PositionResponse]:
        raise NotImplementedError

    async def go_multiple(self, chunk: Chunk) -> List[PositionResponse]:
        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, self._go_multiple_sync, chunk)
        except (EngineError, NotImplementedError):
            raise
        except Exception as e:  # device/kernel errors surface as EngineError
            raise EngineError(f"{self.name} engine failed: {e}") from e

    async def close(self) -> None:
        pass
