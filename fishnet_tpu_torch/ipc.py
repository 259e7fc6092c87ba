"""The work types the engine takes and returns, and their pipe-wire form.

A copy of the part of the JAX package's client/wire.py and client/ipc.py
that the engine needs, with the same wire format: a chunk serialised by
the JAX package's `chunk_to_wire` loads here, and `response_to_wire`
gives the dict the JAX package's engine host would send (reference:
src/ipc.rs:13-118, src/api.rs:120-403).
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import List, Optional

MAX_CHUNK_POSITIONS = 6  # reference: src/ipc.rs:23


class EvalFlavor(enum.Enum):
    NNUE = "nnue"
    HCE = "classical"


class EngineFlavor(enum.Enum):
    """Which engine backend a chunk is routed to (reference:
    src/assets.rs:124-137, plus the batched device engine)."""

    OFFICIAL = "official"
    MULTI_VARIANT = "multivariant"
    TPU = "tpu"

    def eval_flavor(self) -> EvalFlavor:
        if self is EngineFlavor.MULTI_VARIANT:
            return EvalFlavor.HCE
        return EvalFlavor.NNUE


@dataclass(frozen=True)
class NodeLimit:
    """Per-position node budget keyed by engine generation; `get`
    pre-scales by MAX/(MAX+1) to pay for the chunk-overlap position
    (reference: src/api.rs:220-233)."""

    sf16: int
    classical: int

    def get(self, flavor: EvalFlavor) -> int:
        base = self.classical if flavor is EvalFlavor.HCE else self.sf16
        return base * MAX_CHUNK_POSITIONS // (MAX_CHUNK_POSITIONS + 1)


@dataclass(frozen=True)
class AnalysisWork:
    id: str
    nodes: NodeLimit
    timeout_s: float  # per ply
    depth: Optional[int] = None
    multipv: Optional[int] = None

    def effective_multipv(self) -> int:
        return self.multipv or 1


def work_from_json(obj: dict) -> AnalysisWork:
    batch_id = str(obj["id"])
    if len(batch_id) > 24:
        raise ValueError(f"batch id too long: {batch_id!r}")
    kind = obj.get("type")
    if kind == "move":
        raise NotImplementedError("move jobs are not ported to this package yet")
    if kind != "analysis":
        raise ValueError(f"unknown work type: {kind!r}")
    return AnalysisWork(
        id=batch_id,
        nodes=NodeLimit(
            sf16=int(obj["nodes"]["sf16"]),
            classical=int(obj["nodes"]["classical"]),
        ),
        timeout_s=int(obj["timeout"]) / 1000.0,
        depth=int(obj["depth"]) if obj.get("depth") is not None else None,
        multipv=int(obj["multipv"]) if obj.get("multipv") is not None else None,
    )


@dataclass(frozen=True)
class Score:
    """Either a centipawn or a mate score (reference: src/api.rs:391-397)."""

    kind: str  # "cp" | "mate"
    value: int

    def to_json(self) -> dict:
        return {self.kind: self.value}

    @staticmethod
    def cp(value: int) -> "Score":
        return Score("cp", value)

    @staticmethod
    def mate(value: int) -> "Score":
        return Score("mate", value)


@dataclass
class WorkPosition:
    """One position to analyse (reference: src/ipc.rs:26-35);
    position_index None marks a chunk-overlap warm-up position."""

    work: AnalysisWork
    position_index: Optional[int]
    url: Optional[str]
    skip: bool
    root_fen: str
    moves: List[str]


@dataclass
class Chunk:
    """≤6 positions dispatched to one engine as a unit (src/ipc.rs:13-24)."""

    work: AnalysisWork
    deadline: float  # time.monotonic() timestamp
    variant: str
    flavor: EngineFlavor
    positions: List[WorkPosition]


class Matrix:
    """Sparse [multipv-1][depth] matrix; best() = first row, last entry
    (reference: src/ipc.rs:76-96)."""

    def __init__(self) -> None:
        self.matrix: List[List[Optional[object]]] = []

    def set(self, multipv: int, depth: int, value) -> None:
        row_idx = multipv - 1
        while len(self.matrix) <= row_idx:
            self.matrix.append([])
        row = self.matrix[row_idx]
        while len(row) <= depth:
            row.append(None)
        row[depth] = value

    def best(self):
        if not self.matrix or not self.matrix[0]:
            return None
        return self.matrix[0][-1]


@dataclass
class PositionResponse:
    """Result for one position (reference: src/ipc.rs:37-74)."""

    work: AnalysisWork
    position_index: Optional[int]
    url: Optional[str]
    scores: Matrix
    pvs: Matrix
    best_move: Optional[str]
    depth: int
    nodes: int
    time_s: float
    nps: Optional[int] = None


def chunk_from_wire(obj: dict) -> Chunk:
    """Wire dict → Chunk. The wire carries the remaining seconds ("ttl"),
    re-anchored here against this process's monotonic clock."""
    work = work_from_json(obj["work"])
    return Chunk(
        work=work,
        deadline=time.monotonic() + float(obj["ttl"]),
        variant=obj["variant"],
        flavor=EngineFlavor(obj["flavor"]),
        positions=[
            WorkPosition(
                work=work,
                position_index=p["position_index"],
                url=p["url"],
                skip=p["skip"],
                root_fen=p["root_fen"],
                moves=list(p["moves"]),
            )
            for p in obj["positions"]
        ],
    )


def _matrix_to_wire(matrix: Matrix, cell) -> list:
    return [[None if v is None else cell(v) for v in row] for row in matrix.matrix]


def response_to_wire(res: PositionResponse) -> dict:
    return {
        "position_index": res.position_index,
        "url": res.url,
        "scores": _matrix_to_wire(res.scores, lambda s: s.to_json()),
        "pvs": _matrix_to_wire(res.pvs, list),
        "best_move": res.best_move,
        "depth": res.depth,
        "nodes": res.nodes,
        "time_s": res.time_s,
        "nps": res.nps,
    }
