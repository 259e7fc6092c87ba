"""Build, load and launch the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface (`build/kernels-<hash>/lib<name>.so`,
cached by a hash of the sources, the generated headers and the flags; all
sources build at once, one nvcc each). The board kernels (K8-K10) include
`rules_tables.cuh`, which `rules_header` writes into the build directory
from the plain versions' own tables (ops/tables.py, ops/board.py,
ops/movegen.py), and the table and search kernels (K4-K6, K11)
`search_consts.cuh`, which `search_header` writes from ops/search.py and
ops/tt.py, so no table or constant is typed twice. The board and table
kernels (K4, K8-K10) have one entry point per device variant
(`_variant_symbol`); the segment kernel (K11) one library per variant,
each built from search_segment.cu with its generated `segment_entries.cuh`
(one entry point per net kind), all eight nvcc processes started with
the others. The wrappers below take
CUDA tensors only: they check device, dtype, shape and contiguity,
allocate the output with `torch.empty`, launch on the current stream,
raise if the launch returned an error, and count the launch. The callers
(models/nnue.py, models/nnue_import.py, ops/tt.py, ops/board.py,
ops/movegen.py, ops/search.py, models/train.py)
send CPU tensors to their plain PyTorch versions instead; nothing here
falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .ops.tables import VARIANT_ID

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = (
    "nnue_refresh_768", "nnue_forward_from_acc", "nnue_acc_update_768",
    "zobrist_hash", "tt_probe", "tt_store", "lane_init",
    "node_rules", "generate_moves", "make_move", "search_segment",
    "nnue_evaluate", "nnue_evaluate_sf",
    "nnue_stack_backward", "nnue_ft_backward_768", "adam_update",
    "nnue_refresh_kb", "nnue_ft_backward_kb",
)
# the kernels whose bodies K11 runs inside a segment, and its per-launch
# counters: those bodies' calls, then the live lane-steps and the table
# reads (probes and keep-old decisions) that went through a store's
# pending row (csrc/search.cuh Body). K1's body runs there in atomic on a board768 net only (a full
# refresh a leaf); its kernel also refreshes the roots of every board768
# search.
K11_BODIES = (
    "nnue_forward_from_acc", "nnue_acc_update_768", "zobrist_hash", "tt_probe", "tt_store",
    "node_rules", "generate_moves", "make_move", "nnue_evaluate", "nnue_evaluate_sf",
    "nnue_refresh_768",
)
K11_COUNTERS = K11_BODIES + ("live_lane_steps", "pending_reads")

# HalfKAv2_hm feature rows of the full-eval nets (models/nnue.py
# NUM_FEATURES)
NUM_FEATURES = 22528

# length of each Zobrist table (ops/tt.py Z_SHAPE; the kernel reads the
# piece-square, en-passant, castling and side-to-move keys at its head,
# and a variant's salt, threeCheck's counter keys and crazyhouse's pocket
# and promoted keys from its tail)
Z_KEYS = 1409

# launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {name: 0 for name in KERNELS}
# the same launches by entry point (a variant's or a net kind's symbol)
LAUNCHES_BY_ENTRY: dict = {}
# K11's counters since the last reset, on the device: (K11_COUNTERS,)
# int64 per device, each launch adding its warps' counts at its end
_body_calls: dict = {}
# the stores' per-slot claim words per device and stream (_claim_words)
_claims: dict = {}
# K15's and K18's scratch per device, stream and feature rows (_ft_backward)
_ft_scratch: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SEGMENT_ARGS = [_P] * 20 + [_P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 10 + [_P, _P]
# K11's entry point tags, one per net kind and weight type, and
# csrc/search.cuh's net traits
SEGMENT_NETS = (("f32", "NetF32"), ("i8", "NetI8"), ("kb_f32", "NetKbF32"),
                ("kb_i8", "NetKbI8"), ("sf", "NetSf"), ("bf16", "NetBf16"),
                ("kb_bf16", "NetKbBf16"))


def _variant_symbol(base: str, variant: str) -> str:
    """An entry point's name in a device variant: the standard one keeps
    its base name, the others take the variant's as a suffix."""
    if variant not in VARIANT_ID:
        raise NotImplementedError(f"{variant!r} is not a device variant")
    return base if variant == "standard" else f"{base}_{variant}"


def _per_variant(base: str, argtypes) -> dict:
    return {_variant_symbol(base, v): argtypes for v in VARIANT_ID}


# each library: its entry points and their argument types (a library is
# built from csrc/<its name>.cu, but K11's libraries search_segment_<variant>,
# which are built from search_segment.cu, _LIBRARY_SOURCE)
_SIGNATURES = {
    "nnue_refresh_768": {f"nnue_refresh_768_{tag}": [_P, _P, _P, _P, _I, _I, _P]
                         for tag in ("f32", "i16", "bf16")},
    "nnue_acc_update_768": {f"nnue_acc_update_768_{tag}": [_P, _P, _P, _P, _P, _P, _I, _I, _P]
                            for tag in ("f32", "i16", "bf16")},
    "nnue_forward_from_acc": {f"nnue_forward_from_acc_{tag}": [_P] * 10 + [_I, _P]
                              for tag in ("f32", "i8", "bf16")},
    "nnue_evaluate": {f"nnue_evaluate_{tag}": [_P, _L, _P, _L] + [_P] * 9 + [_I] * 4 + [_P]
                      for tag in ("f32", "i8", "bf16")},
    "nnue_evaluate_sf": {"nnue_evaluate_sf": [_P, _L, _P, _L] + [_P] * 11 + [_I] * 2 + [_P]},
    "zobrist_hash": _per_variant("zobrist_hash", [_P, _L] * 5 + [_P, _P, _P, _I, _P]),
    "tt_probe": {"tt_probe": [_P, _I] + [_P, _L] * 5 + [_P, _I, _P, _P, _P, _I, _P]},
    "tt_store": {"tt_store": [_P, _I] + [_P, _L] * 6 + [_P, _P, _I, _I, _P, _P, _I, _P]},
    "lane_init": {"lane_init": [_P] * 20 + [_I] * 5 + [_P]},
    "node_rules": _per_variant("node_rules", [_P, _L] * 3 + [_P, _P, _P, _I, _P]),
    "generate_moves": _per_variant("generate_moves", [_P, _L] * 7 + [_P, _P, _P, _I, _P]),
    "make_move": _per_variant("make_move", [_P, _L] * 7 + [_P] * 4 + [_I, _P]),
    **{f"search_segment_{v}": {_variant_symbol(f"search_segment_{tag}", v): _SEGMENT_ARGS
                               for tag, _ in SEGMENT_NETS} for v in VARIANT_ID},
    "nnue_stack_backward": {"nnue_stack_backward": [_P] * 13 + [_I, _P]},
    "nnue_ft_backward_768": {"nnue_ft_backward_768": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "adam_update": {"adam_update": [_P] * 4 + [_L] + [_F] * 8 + [_P]},
    "nnue_refresh_kb": {"nnue_refresh_kb": [_P, _P, _P, _P, _I, _I, _P]},
    "nnue_ft_backward_kb": {"nnue_ft_backward_kb": [_P, _P, _P, _P, _I, _I, _I, _P]},
}
# the kernel (csrc source and LAUNCHES key) of each library
_LIBRARY_SOURCE = {lib: ("search_segment" if lib.startswith("search_segment_") else lib)
                   for lib in _SIGNATURES}

# the search state's fixed widths K7 writes (ops/search.py BT_W, NT_W,
# LN_W, MAX_HIST and the history table)
BT_W, NT_W, LN_W, MAX_HIST, HIST_SIZE = 96, 16, 16, 16, 4096
# K11: the deepest stack it takes (it stages a PV row in two words a
# thread), the board768 net's widths, which K2's and K3's bodies are
# compiled for (the shipped net's; K3's body takes L1 four columns a
# thread), and its per-lane scratch words (its two stores' staged rows
# and slots, an int4 each)
SEGMENT_MAX_PLY = 64
SEGMENT_L1 = 64
SEGMENT_H1 = 16
SEGMENT_H2 = 32
SHIPPED_WIDTHS = (SEGMENT_L1, SEGMENT_H1, SEGMENT_H2)
SEGMENT_SCRATCH = 16
# K11 on a Stockfish net (csrc/search.cuh sf_post, sf_own, sf_help): its
# control words and one job record a lane (the lists, stm, bucket, the
# units' counters), then one eval buffer a lane: the pairwise products
# (L1 rounded up to whole 4-float vectors) and the 16 x 32 fc0 chains
# (csrc/nnue.cuh sf_buffer_floats)
SF_CTL_W = 8
SF_JOB_W = 144
SF_CHAINS = 16 * 32
# K14's per-sample scratch row (csrc/nnue_stack_backward.cu: h1, dz1, h2,
# dz2, d_out) and the number of head gradients it writes, at the shipped
# widths it is compiled for
STACK_SCRATCH_W = 2 * (SEGMENT_H1 + SEGMENT_H2) + 1
STACK_GRADS = 8 * (2 * SEGMENT_L1 * SEGMENT_H1 + SEGMENT_H1 + SEGMENT_H1 * SEGMENT_H2
                   + 2 * SEGMENT_H2 + 1)
# the widths the full evals take at run time: K12/K13 an even L1 up to
# Stockfish's big net's, K12 up to 32 units in each hidden layer
# (csrc/nnue.cuh MAX_H)
MAX_L1 = 3072
MAX_HIDDEN = 32
# K15's and K18's window of (sample, perspective) pairs: a bitmap row's
# bits (csrc/ft_backward.cuh)
FT_WINDOW = 1024
# the grid of K11's last launch (blocks), for the logs
LAST_GRID = {"blocks": 0}

_lock = threading.Lock()
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_ENTRY.clear()
    for counts in _body_calls.values():
        counts.zero_()


def body_calls() -> dict:
    """K11's counters since the last reset, summed over the devices:
    {name: count} for K11_COUNTERS (a host read of the counters)."""
    total = np.zeros(len(K11_COUNTERS), np.int64)
    for counts in _body_calls.values():
        total += counts.cpu().numpy()
    return dict(zip(K11_COUNTERS, total.tolist()))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _c_array(name: str, ctype: str, values) -> str:
    flat = np.asarray(values).astype(np.int64).reshape(-1)
    return (f"static __device__ const {ctype} {name}[{flat.size}] = {{"
            + ", ".join(str(v) for v in flat) + "};")


def rules_header() -> str:
    """The text of `rules_tables.cuh`: the board kernels' static tables
    and constants, written from the modules the plain versions read."""
    from .ops import board, movegen
    from .ops import tables as T

    consts = {
        **{k: getattr(T, k) for k in (
            "W_PAWN", "W_KNIGHT", "W_BISHOP", "W_ROOK", "W_QUEEN", "W_KING", "B_KING",
            "PROMO_Q", "MAX_MOVES")},
        **{k: getattr(movegen, k) for k in (
            "QUIET_KEY", "CASTLE_KEY", "KILLER_KEY", "NOISY_BELOW", "HIST_BASE",
            "HIST_SHIFT", "HIST_MAX_BONUS", "QUEEN_PROMO_BONUS", "MAX_MOVES_ZH", "DROP_FLAG",
            "DROP_KEY", "DROP_HIST_BASE")},
        **{k: getattr(board, k) for k in (
            "BT_BOARD", "BT_STM", "BT_EP", "BT_CAST", "BT_HM", "BT_EXTRA", "BT_PH1", "BT_PH2",
            "BT_W", "EXTRA_W", "EXTRA_CHECKS", "THREE_CHECKS", "EXTRA_POCKET", "EXTRA_PROMOTED",
            "POCKET_TYPES", "TERM_NONE", "TERM_LOSS", "TERM_WIN", "TERM_DRAW",
            "GOAL_RANK_FROM")},
        "PROMO_K": T.PROMO_K,
        **_variant_consts(),
    }
    arrays = (
        ("RAYS", "int8_t", T.RAYS),  # [sq][dir][step], -1 past the edge
        ("KNIGHT_TARGETS", "int8_t", T.KNIGHT_TARGETS),  # [sq][i], -1 padded
        ("KING_TARGETS", "int8_t", T.KING_TARGETS),
        ("PAWN_CAPTURES", "int8_t", T.PAWN_CAPTURES),  # [color][sq][i]
        ("SLIDER_MASK", "uint8_t", T.SLIDER_MASK),  # [dir][code]
        ("PROMO_TO_PIECE", "int8_t", T.PROMO_TO_PIECE),  # white codes, +6 black
        ("PIECE_TYPE", "int8_t", board.PIECE_TYPE),  # [code], -1 empty
        ("PIECE_COLOR", "int8_t", board.PIECE_COLOR),
        ("CASTLE_KING_TO", "int8_t", board.CASTLE_KING_TO),  # [color * 2 + side]
        ("CASTLE_ROOK_TO", "int8_t", board.CASTLE_ROOK_TO),
        ("CASTLE_SLOT_COLOR", "int8_t", board.CASTLE_SLOT_COLOR),
        ("CHANGE_SIGNS", "int8_t", board.CHANGE_SIGNS),
        # [color][single, double][sq], clipped to the board as the plain version's
        ("PAWN_PUSH", "int8_t", [[movegen._TO1[c], movegen._TO2[c]] for c in (0, 1)]),
        ("PAWN_START", "uint8_t", movegen._START_RANK),  # [color][sq]
        ("PAWN_PRE_PROMO", "uint8_t", movegen._PRE_PROMO),
        ("PROMOS", "int8_t", movegen._PROMOS),
        ("PAIR_KEY", "int16_t", movegen._PAIR_KEY),  # [mover * 13 + target]
        ("PAIR_TAKE", "uint8_t", movegen._PAIR_TAKE),
        ("PAWN_CAP_KEY", "int16_t", movegen._PAWN_CAP_KEY),  # [target code]
        ("HILL", "int8_t", board.HILL),  # kingOfTheHill's centre squares
        ("DROP_OK", "uint8_t", movegen._DROP_OK),  # [type][sq]: crazyhouse may drop there
    )
    lines = [
        "// Generated by fishnet_tpu_torch/kernels.py rules_header() from",
        "// ops/tables.py, ops/board.py and ops/movegen.py; not a source file.",
        "#pragma once",
        "#include <cstdint>",
        "namespace rules {",
        *[f"constexpr int {k} = {int(v)};" for k, v in consts.items()],
        *[_c_array(name, ctype, values) for name, ctype, values in arrays],
        "}  // namespace rules",
    ]
    return "\n".join(lines) + "\n"


def _variant_consts() -> dict:
    """VARIANT_<NAME> = id for every device variant (ops/tables.py)."""
    return {f"VARIANT_{name.upper()}": vid for name, vid in VARIANT_ID.items()}


def segment_entries(variant: str) -> str:
    """The text of one variant's `segment_entries.cuh`: K11's entry points
    for that variant, one per net kind (csrc/search_segment.cu
    SEGMENT_ENTRY)."""
    lines = [
        "// Generated by fishnet_tpu_torch/kernels.py segment_entries(); not a source file.",
        *[f"SEGMENT_ENTRY({_variant_symbol(f'search_segment_{tag}', variant)}, search::{net}, "
          f"consts::VARIANT_{variant.upper()})" for tag, net in SEGMENT_NETS],
    ]
    return "\n".join(lines) + "\n"


def search_header() -> str:
    """The text of `search_consts.cuh`: the search's and the table's
    constants (the state's field indices, modes, scores, pruning margins,
    the TT flags and key layout, the null child's row map), written from
    ops/search.py and ops/tt.py, the modules the plain versions read, and
    the limits of K11's layout that its wrapper checks."""
    from .ops import board, search, tt

    names = [k for k in vars(search) if k.startswith(("NT_", "LN_", "MODE_", "SUM_"))]
    names += ["MATE", "INF", "ILLEGAL", "DRAW", "MATE_BOUND", "NULL_R", "NULL_MIN_DEPTH",
              "NULL_DEEP_DEPTH", "FIFTY_PLIES", "FUTILITY_DEPTH", "FUTILITY_MARGIN_1",
              "FUTILITY_MARGIN_2", "LMR_MIN_DEPTH", "LMR_MIN_MOVE", "LMR_DEEP_MOVE",
              "MAX_HIST", "HIST_SIZE", "HIST_BONUS_MAX", "HIST_MAX"]
    consts = {k: getattr(search, k) for k in names}
    consts.update({k: getattr(tt, k) for k in ("FLAG_EXACT", "FLAG_LOWER", "FLAG_UPPER")})
    consts.update(SEGMENT_MAX_PLY=SEGMENT_MAX_PLY, SEGMENT_SCRATCH=SEGMENT_SCRATCH,
                  SF_CTL_W=SF_CTL_W, SF_JOB_W=SF_JOB_W,
                  SEGMENT_L1=SEGMENT_L1, SEGMENT_H1=SEGMENT_H1, SEGMENT_H2=SEGMENT_H2,
                  MAX_L1=MAX_L1, FT_WINDOW=FT_WINDOW)
    consts.update({k.lstrip("_"): getattr(tt, k) for k in (
        "_SCORE_BIAS", "_DEPTH_MASK", "_MAX_STORE", "_EP_OFF", "_CASTLE_OFF", "_STM_OFF",
        "_CHECKS_OFF", "_POCKET_OFF", "_PROMOTED_OFF", "_VARIANT_OFF", "POCKET_MAX")})
    consts.update({k: getattr(board, k) for k in (
        "EXTRA_CHECKS", "THREE_CHECKS", "EXTRA_POCKET", "EXTRA_PROMOTED", "POCKET_TYPES")})
    consts.update(_variant_consts())
    arrays = (
        ("NULL_MUL", "int32_t", search._NULL_MUL),  # the null child's row: parent * MUL + ADD
        ("NULL_ADD", "int32_t", search._NULL_ADD),
    )
    lines = [
        "// Generated by fishnet_tpu_torch/kernels.py search_header() from",
        "// ops/search.py and ops/tt.py; not a source file.",
        "#pragma once",
        "#include <cstdint>",
        "namespace consts {",
        *[f"constexpr int {k} = {int(v)};" for k, v in consts.items()],
        *[_c_array(name, ctype, values) for name, ctype, values in arrays],
        "}  // namespace consts",
    ]
    return "\n".join(lines) + "\n"


def _headers() -> dict:
    """The generated headers the kernels include, by their path in the
    build directory (K11's per-variant entries in a directory per
    library)."""
    return {
        "rules_tables.cuh": rules_header(), "search_consts.cuh": search_header(),
        **{f"search_segment_{v}/segment_entries.cuh": segment_entries(v)
           for v in VARIANT_ID},
    }


def _build_dir(header: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(header.encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def build() -> float:
    """Build (or find built) every kernel library and bind its entry
    points; returns the seconds it took. Raises if any build fails."""
    with _lock:
        if _fns:
            return 0.0
        t0 = time.monotonic()
        headers = _headers()
        out = _build_dir("".join(headers.values()))
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in headers.items():  # the build directory is keyed by their text
            dest = out / fname
            if not dest.exists():  # another process may be compiling against it
                dest.parent.mkdir(exist_ok=True)
                tmp = out / f"{fname}.tmp{os.getpid()}"
                tmp.write_text(text)
                os.replace(tmp, dest)
        procs = {}
        for name, source in _LIBRARY_SOURCE.items():
            lib = out / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out / f"lib{name}.so.tmp{os.getpid()}"
            own = out / name  # a library's own generated headers (K11's entries)
            includes = ["-I", str(own)] if own.is_dir() else []
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *includes, "-I", str(out), "-o", str(tmp),
                 str(CSRC / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, lib)
        errors = []
        try:
            for name, (proc, tmp, lib) in procs.items():
                log, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                else:
                    os.replace(tmp, lib)
        finally:  # a timed-out or failed build leaves no nvcc running
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        fns = {}
        for name in _LIBRARY_SOURCE:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            for sym, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[sym] = fn
        _fns.update(fns)
        return time.monotonic() - t0


def _launch(kernel: str, sym: str, device: torch.device, *args) -> None:
    """Launch entry point `sym` on `device`, the card its tensors lie on:
    with that card current (the runtime launches on the current device)
    and on its current stream, whichever card is current for the caller."""
    if not _fns:
        build()
    with torch.cuda.device(device):
        rc = _fns[sym](*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{sym} launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1
    LAUNCHES_BY_ENTRY[sym] = LAUNCHES_BY_ENTRY.get(sym, 0) + 1


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    _check_device(t, name)
    _check_layout(t, name, dtype, shape)


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _check_layout(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# each weight type a net may have, by ft_w's dtype: its tag in the entry
# points of K1 and K3 and in those of K2, K11 and K12, the accumulators'
# dtype, ft_b's, the head weights' and the head biases' (bf16: the
# weights stored in bf16, the arithmetic and the accumulators f32)
NET_TYPES = {
    torch.float32: ("f32", "f32", torch.float32, torch.float32, torch.float32, torch.float32),
    torch.int16: ("i16", "i8", torch.int32, torch.int32, torch.int8, torch.int32),
    torch.bfloat16: ("bf16", "bf16", torch.float32, torch.bfloat16, torch.bfloat16,
                     torch.bfloat16),
}


def _net_types(ft_w: torch.Tensor):
    """ft_w's dtype → (K1's and K3's entry tag, the accumulators' dtype,
    ft_b's dtype)."""
    if ft_w.dtype not in NET_TYPES:
        raise TypeError(f"ft_w must be float32, bfloat16 or int16, got {ft_w.dtype}")
    tag, _, adt, fdt, _, _ = NET_TYPES[ft_w.dtype]
    return tag, adt, fdt


def nnue_refresh_768(boards: torch.Tensor, ft_w: torch.Tensor,
                     ft_b: torch.Tensor) -> torch.Tensor:
    """K1: boards (B, 64) int32 → acc (B, 2, L1) (f32 for f32 and bf16
    weights, int32 for the int8 net)."""
    B, l1 = boards.shape[0], ft_w.shape[1]
    tag, adt, fdt = _net_types(ft_w)
    _check(boards, "boards", torch.int32, (B, 64))
    _check(ft_w, "ft_w", ft_w.dtype, (768, l1))
    _check(ft_b, "ft_b", fdt, (l1,))
    if not 0 < l1 <= 256:
        raise ValueError(f"L1 {l1} is outside the kernel's 1..256 columns")
    acc = torch.empty((B, 2, l1), dtype=adt, device=boards.device)
    if B:
        _launch("nnue_refresh_768", f"nnue_refresh_768_{tag}", boards.device,
                boards.data_ptr(), ft_w.data_ptr(), ft_b.data_ptr(),
                acc.data_ptr(), B, l1)
    return acc


def nnue_acc_update_768(acc: torch.Tensor, codes: torch.Tensor,
                        sqs: torch.Tensor, signs: torch.Tensor,
                        ft_w: torch.Tensor) -> torch.Tensor:
    """K3: acc (B, 2, L1), codes/sqs/signs (B, 4) int32 → the updated
    (B, 2, L1) accumulators (a new tensor)."""
    B, l1 = acc.shape[0], ft_w.shape[1]
    tag, adt, _ = _net_types(ft_w)
    _check(acc, "acc", adt, (B, 2, l1))
    for name, t in (("codes", codes), ("sqs", sqs), ("signs", signs)):
        _check(t, name, torch.int32, (B, 4))
    _check(ft_w, "ft_w", ft_w.dtype, (768, l1))
    if not 0 < l1 <= 256:
        raise ValueError(f"L1 {l1} is outside the kernel's 1..256 columns")
    out = torch.empty_like(acc)
    if B:
        _launch("nnue_acc_update_768", f"nnue_acc_update_768_{tag}", acc.device,
                acc.data_ptr(), codes.data_ptr(), sqs.data_ptr(),
                signs.data_ptr(), ft_w.data_ptr(), out.data_ptr(), B, l1)
    return out


def _head_types(params):
    """The layer stack's net tag and accumulator dtype and its widths (K2,
    K12, K11, K14) → (tag, acc dtype, (L1, H1, H2)), after checking the
    head weights: 8 buckets of 2*L1 → H1 → H2 → 1, H1 and H2 at most
    MAX_HIDDEN, L1 at most MAX_L1 (K2 takes the shipped widths only). The
    stack reads neither ft_w nor ft_b: L1 is l1_w's, so a tp shard of the
    trainer's grid, whose ft_w and ft_b hold a block of the columns, runs
    the stack on the gathered accumulators; ft_w's dtype names the net's
    weight type."""
    if params.ft_w.dtype not in NET_TYPES:
        raise TypeError(f"unsupported net dtype {params.ft_w.dtype}")
    _, tag, adt, _, wdt, bdt = NET_TYPES[params.ft_w.dtype]
    l1, h1, h2 = params.l1_w.shape[1] // 2, params.l1_w.shape[-1], params.l2_w.shape[-1]
    if not 0 < l1 <= MAX_L1 or not 0 < h1 <= MAX_HIDDEN or not 0 < h2 <= MAX_HIDDEN:
        raise ValueError(f"the layer stack takes L1 1..{MAX_L1} and hidden widths 1.."
                         f"{MAX_HIDDEN}, got {l1}, {h1}, {h2}")
    for name, shape, dt in (
        ("l1_w", (8, 2 * l1, h1), wdt), ("l1_b", (8, h1), bdt),
        ("l2_w", (8, h1, h2), wdt), ("l2_b", (8, h2), bdt),
        ("out_w", (8, h2), wdt), ("out_b", (8,), bdt),
    ):
        _check(getattr(params, name), name, dt, shape)
    return tag, adt, (l1, h1, h2)


def nnue_forward_from_acc(acc: torch.Tensor, stm: torch.Tensor,
                          bucket: torch.Tensor, params) -> torch.Tensor:
    """K2: acc (B, 2, 64) (f32 for f32 and bf16 weights, int32 for the
    int8 net), stm/bucket (B,) int32 → eval (B,) f32, for the shipped
    net's widths (L1 64, 8 buckets of 128→16→32→1), which its kernel is
    compiled for."""
    B = acc.shape[0]
    tag, adt, widths = _head_types(params)
    if widths != SHIPPED_WIDTHS:
        raise ValueError(f"K2 takes the shipped net's widths {SHIPPED_WIDTHS}, got {widths}")
    _check(acc, "acc", adt, (B, 2, SEGMENT_L1))
    _check(stm, "stm", torch.int32, (B,))
    _check(bucket, "bucket", torch.int32, (B,))
    out = torch.empty((B,), dtype=torch.float32, device=acc.device)
    if B:
        _launch("nnue_forward_from_acc", f"nnue_forward_from_acc_{tag}", acc.device,
                acc.data_ptr(), stm.data_ptr(), bucket.data_ptr(),
                params.l1_w.data_ptr(), params.l1_b.data_ptr(),
                params.l2_w.data_ptr(), params.l2_b.data_ptr(),
                params.out_w.data_ptr(), params.out_b.data_ptr(),
                out.data_ptr(), B)
    return out


def _check_ft(params, rows: int, l1: int) -> None:
    """The feature transform of a net whose widths _head_types read: ft_w
    (rows, L1) and ft_b (L1,) in its weight type's dtypes."""
    _, _, _, fdt, _, _ = NET_TYPES[params.ft_w.dtype]
    _check(params.ft_w, "ft_w", params.ft_w.dtype, (rows, l1))
    _check(params.ft_b, "ft_b", fdt, (l1,))


def _check_full_l1(l1: int) -> None:
    if l1 % 2 or not 0 < l1 <= MAX_L1:
        raise ValueError(f"the full-eval kernels take an even L1 up to {MAX_L1}, got {l1}")


def _kb_weights(params):
    """A king-bucketed net's checks (K12, K11) → (tag, widths, its eight
    weight pointers: ft_w, ft_b, the head's six)."""
    tag, _, widths = _head_types(params)
    _check_full_l1(widths[0])
    _check_ft(params, NUM_FEATURES, widths[0])
    return tag, widths, [t.data_ptr() for t in params]


SF_FIELDS = ("ft_w", "ft_b", "psqt_w", "fc0_w", "fc0_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _sf_weights(net):
    """An imported Stockfish net's checks (K13, K11) → (L1, its nine
    weight pointers in SF_FIELDS order)."""
    l1 = net.ft_w.shape[1]
    _check_full_l1(l1)
    for name, shape in (
        ("ft_w", (NUM_FEATURES, l1)), ("ft_b", (l1,)), ("psqt_w", (NUM_FEATURES, 8)),
        ("fc0_w", (8, 16, l1)), ("fc0_b", (8, 16)), ("fc1_w", (8, 32, 30)),
        ("fc1_b", (8, 32)), ("fc2_w", (8, 1, 32)), ("fc2_b", (8, 1)),
    ):
        _check(getattr(net, name), name, torch.float32, shape)
    return l1, [getattr(net, f).data_ptr() for f in SF_FIELDS]


def nnue_evaluate(boards: torch.Tensor, stm: torch.Tensor, params) -> torch.Tensor:
    """K12: a king-bucketed net's (NnueParams with NUM_FEATURES rows,
    f32, bf16 or int8) full eval of boards (B, 64), stm (B,) — int32, rows may
    be strided views — → (B,) f32."""
    B = boards.shape[0]
    sb = _check_rows(boards, "boards", (B, 64))
    ss = _check_rows(stm, "stm", (B,))
    tag, widths, ptrs = _kb_weights(params)
    out = torch.empty((B,), dtype=torch.float32, device=boards.device)
    if B:
        _launch("nnue_evaluate", f"nnue_evaluate_{tag}", boards.device, boards.data_ptr(), sb,
                stm.data_ptr(), ss, *ptrs, out.data_ptr(), B, *widths)
    return out


def sf_buffer_floats(l1: int) -> int:
    """One Stockfish eval's buffer in floats (csrc/nnue.cuh
    sf_buffer_floats): its pairwise products, L1 rounded up to whole
    4-float vectors, then its fc0 chains' sums."""
    return (l1 + 3) // 4 * 4 + SF_CHAINS


def nnue_evaluate_sf(boards: torch.Tensor, stm: torch.Tensor, net) -> torch.Tensor:
    """K13: an imported Stockfish net's (models/nnue_import.py
    StockfishNet, f32) full eval of boards (B, 64), stm (B,) — int32,
    rows may be strided views — → (B,) f32. Three launches (the
    feature-transform units, the fc0 units, the close) through a
    (B, sf_buffer_floats(L1)) f32 scratch buffer; one counted call."""
    B = boards.shape[0]
    sb = _check_rows(boards, "boards", (B, 64))
    ss = _check_rows(stm, "stm", (B,))
    l1, ptrs = _sf_weights(net)
    out = torch.empty((B,), dtype=torch.float32, device=boards.device)
    if B:
        buf = torch.empty((B, sf_buffer_floats(l1)), dtype=torch.float32, device=boards.device)
        _launch("nnue_evaluate_sf", "nnue_evaluate_sf", boards.device, boards.data_ptr(), sb,
                stm.data_ptr(), ss, *ptrs, buf.data_ptr(), out.data_ptr(), B, l1)
    return out


def _check_rows(t: torch.Tensor, name: str, shape) -> int:
    """A (B, ...) int32 CUDA view whose trailing dims are contiguous;
    returns its batch stride in elements."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dim() == 2 and t.stride(1) != 1:
        raise ValueError(f"{name} rows must be contiguous")
    return t.stride(0) if t.shape[0] > 1 else 1


def _extra_rows(extra, B: int, variant: str) -> tuple:
    """The variant words (B, 12) a kernel reads → (pointer, batch
    stride); threeCheck and crazyhouse must pass them, the others may
    pass None."""
    if extra is None:
        if variant in ("threeCheck", "crazyhouse"):
            raise ValueError(f"{variant} needs the boards' extra words")
        return None, 0
    return extra.data_ptr(), _check_rows(extra, "extra", (B, 12))


def zobrist_hash(board: torch.Tensor, stm: torch.Tensor, ep: torch.Tensor,
                 castling: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor,
                 extra=None, variant: str = "standard") -> torch.Tensor:
    """K4: board (B, 64), stm/ep (B,), castling (B, 4), extra (B, 12) or
    None (read in threeCheck and crazyhouse only) — int32, rows may be
    strided views — → (B, 2) int32 key bit patterns, under the device
    variant's keys."""
    B = board.shape[0]
    sym = _variant_symbol("zobrist_hash", variant)
    sb = _check_rows(board, "board", (B, 64))
    ss = _check_rows(stm, "stm", (B,))
    se = _check_rows(ep, "ep", (B,))
    sc = _check_rows(castling, "castling", (B, 4))
    ext = _extra_rows(extra, B, variant)
    _check(z1, "z1", torch.int32, (Z_KEYS,))
    _check(z2, "z2", torch.int32, (Z_KEYS,))
    out = torch.empty((B, 2), dtype=torch.int32, device=board.device)
    if B:
        _launch("zobrist_hash", sym, board.device,
                board.data_ptr(), sb, stm.data_ptr(), ss, ep.data_ptr(), se,
                castling.data_ptr(), sc, *ext, z1.data_ptr(), z2.data_ptr(),
                out.data_ptr(), B)
    return out


def _check_lanes(t: torch.Tensor, name: str, B: int, dtype=torch.int32) -> int:
    """A (B,) CUDA view of `dtype`; returns its element stride (0 for a
    broadcast scalar)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != (B,):
        raise ValueError(f"{name} must have shape {(B,)}, got {tuple(t.shape)}")
    return t.stride(0)


def _check_table(table: torch.Tensor) -> int:
    n = table.shape[0]
    _check(table, "table", torch.int32, (n, 4))
    if n & (n - 1) or not 0 < n < 2**31:
        raise ValueError(f"table must have a power-of-two number of rows, got {n}")
    if table.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned")
    return n


def tt_probe(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
             depth_left: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
             enter: torch.Tensor, deep_bounds: bool):
    """K5: table (n, 4) int32; h1, h2, depth_left, alpha, beta (B,) int32
    views (any stride); enter (B,) bool → (usable (B,) bool, score (B,)
    int32, order_move (B,) int32)."""
    B = h1.shape[0]
    n = _check_table(table)
    strides = [_check_lanes(t, name, B) for name, t in (
        ("h1", h1), ("h2", h2), ("depth_left", depth_left), ("alpha", alpha), ("beta", beta))]
    _check(enter, "enter", torch.bool, (B,))
    usable = torch.empty((B,), dtype=torch.bool, device=table.device)
    score = torch.empty((B,), dtype=torch.int32, device=table.device)
    order = torch.empty((B,), dtype=torch.int32, device=table.device)
    if B:
        args = [a for t, s in zip((h1, h2, depth_left, alpha, beta), strides)
                for a in (t.data_ptr(), s)]
        _launch("tt_probe", "tt_probe", table.device, table.data_ptr(), n, *args,
                enter.data_ptr(), int(bool(deep_bounds)), usable.data_ptr(),
                score.data_ptr(), order.data_ptr(), B)
    return usable, score, order


def tt_store(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
             score: torch.Tensor, depth: torch.Tensor, flag: torch.Tensor,
             move: torch.Tensor, mask: torch.Tensor, prefer_deep: bool,
             gen=None) -> torch.Tensor:
    """K6: stores each masked lane's entry into table (n, 4) int32, in
    place, and returns it. h1, h2, score, depth, flag, move (B,) int32
    views (any stride, 0 for a broadcast scalar); mask (B,) bool; gen
    None, an int or a (B,) int32 CUDA tensor. Two launches on the current
    stream (claim, commit) through that stream's claim words."""
    B = h1.shape[0]
    n = _check_table(table)
    cols = (("h1", h1), ("h2", h2), ("score", score), ("depth", depth), ("flag", flag),
            ("move", move))
    strides = [_check_lanes(t, name, B) for name, t in cols]
    _check(mask, "mask", torch.bool, (B,))
    gen_ptr, gen_int = None, 0
    if torch.is_tensor(gen):
        _check(gen, "gen", torch.int32, (B,))
        gen_ptr = gen.data_ptr()
    elif gen is not None:
        gen_int = int(gen)
    if B:
        args = [a for (_, t), s in zip(cols, strides) for a in (t.data_ptr(), s)]
        claims = _claim_words(table.device, n)
        scratch = torch.empty((B, 8), dtype=torch.int32, device=table.device)
        _launch("tt_store", "tt_store", table.device, table.data_ptr(), n, *args,
                mask.data_ptr(), gen_ptr, gen_int, int(bool(prefer_deep)), claims.data_ptr(),
                scratch.data_ptr(), B)
    return table


def _check_state(state) -> tuple:
    """The nine tables of a search state (ops/search.py SearchState):
    contiguous tensors of consistent shapes → (B, P + 1, the move list's
    width, L1). Their device is _check_devices'."""
    B, p1 = state.bt.shape[0], state.bt.shape[1]
    p = p1 - 1
    max_moves, l1 = state.moves.shape[2], state.acc.shape[3]
    adt = state.acc.dtype
    if adt not in (torch.float32, torch.int32):
        raise TypeError(f"acc must be float32 or int32, got {adt}")
    for name, t, dt, shape in (
        ("bt", state.bt, torch.int32, (B, p1, BT_W)),
        ("nt", state.nt, torch.int32, (B, p1, NT_W)),
        ("lane", state.lane, torch.int32, (B, LN_W)),
        ("hist_hash", state.hist_hash, torch.int32, (B, MAX_HIST, 2)),
        ("hist_halfmove", state.hist_halfmove, torch.int32, (B, MAX_HIST)),
        ("moves", state.moves, torch.int32, (B, p, max_moves)),
        ("hist", state.hist, torch.int32, (B, HIST_SIZE)),
        ("pv", state.pv, torch.int32, (B, p, p)),
        ("acc", state.acc, adt, (B, p1, 2, l1)),
    ):
        _check_layout(t, name, dt, shape)
    return B, p1, max_moves, l1


def _check_devices(state) -> None:
    for name, t in zip(state._fields, state):
        _check_device(t, name)


def lane_init(state, lane_idx: torch.Tensor, rows: torch.Tensor, root_acc: torch.Tensor,
              depth: torch.Tensor, budget: torch.Tensor, alpha: torch.Tensor,
              beta: torch.Tensor, jitter: torch.Tensor, group: torch.Tensor,
              hist_hash: torch.Tensor, hist_halfmove: torch.Tensor) -> None:
    """K7: writes init_state's values into the lanes lane_idx (n,) int64
    (distinct) of `state` (ops/search.py SearchState, contiguous (B, ...)
    tables), in place. rows (n, BT_W) int32 root board rows; root_acc
    (n, 2, L1) in the accumulators' dtype (K1's output); depth, budget,
    alpha, beta, jitter, group (n,) int32; hist_hash (n, MAX_HIST, 2)
    and hist_halfmove (n, MAX_HIST) int32."""
    B, p1, max_moves, l1 = _check_state(state)
    _check_devices(state)
    adt = state.acc.dtype
    n = lane_idx.shape[0]
    _check(lane_idx, "lane_idx", torch.int64, (n,))
    _check(rows, "rows", torch.int32, (n, BT_W))
    _check(root_acc, "root_acc", adt, (n, 2, l1))
    cols = (depth, budget, alpha, beta, jitter, group)
    for name, t in zip(("depth", "budget", "alpha", "beta", "jitter", "group"), cols):
        _check(t, name, torch.int32, (n,))
    _check(hist_hash, "hist_hash (rows)", torch.int32, (n, MAX_HIST, 2))
    _check(hist_halfmove, "hist_halfmove (rows)", torch.int32, (n, MAX_HIST))
    if n:
        _launch("lane_init", "lane_init", state.lane.device, *[t.data_ptr() for t in state],
                lane_idx.data_ptr(), rows.data_ptr(), root_acc.data_ptr(),
                *[t.data_ptr() for t in cols], hist_hash.data_ptr(),
                hist_halfmove.data_ptr(), B, n, p1, max_moves, l1)


def node_rules(board: torch.Tensor, stm: torch.Tensor, extra=None,
               variant: str = "standard"):
    """K8: board (B, 64), stm (B,), extra (B, 12) or None (read in
    threeCheck only) — int32, rows may be strided views — → (parent_illegal,
    checked (B,) bool, term_kind (B,) int32) under the device variant's
    rules."""
    B = board.shape[0]
    sym = _variant_symbol("node_rules", variant)
    sb = _check_rows(board, "board", (B, 64))
    ss = _check_rows(stm, "stm", (B,))
    ext = _extra_rows(extra, B, variant)
    out = torch.empty((2, B), dtype=torch.bool, device=board.device)
    term = torch.empty((B,), dtype=torch.int32, device=board.device)
    if B:
        _launch("node_rules", sym, board.device, board.data_ptr(), sb, stm.data_ptr(), ss,
                *ext, out[0].data_ptr(), out[1].data_ptr(), term.data_ptr(), B)
    return out[0], out[1], term


def generate_moves(board: torch.Tensor, stm: torch.Tensor, ep: torch.Tensor,
                   castling: torch.Tensor, killers=None, hist=None, variant: str = "standard",
                   extra=None):
    """K9: board (B, 64), stm/ep (B,), castling (B, 4), killers (B, 2) or
    None, hist (B, 4096) or None, extra (B, 12) or None (read in
    crazyhouse only: the pockets) — int32, rows may be strided views with
    contiguous rows — → (moves (B, max_moves_for(variant)), count (B,),
    noisy (B,)) int32, moves ordered and -1 padded, under the device
    variant's rules."""
    from .ops.movegen import max_moves_for

    B = board.shape[0]
    sym = _variant_symbol("generate_moves", variant)
    strides = [_check_rows(t, name, shape) for name, t, shape in (
        ("board", board, (B, 64)), ("stm", stm, (B,)), ("ep", ep, (B,)),
        ("castling", castling, (B, 4)))]
    opt = []
    for name, t, width in (("killers", killers, 2), ("hist", hist, HIST_SIZE)):
        if t is None:
            opt += [None, 0]
        else:
            opt += [t.data_ptr(), _check_rows(t, name, (B, width))]
    opt += _extra_rows(extra, B, variant)
    moves = torch.empty((B, max_moves_for(variant)), dtype=torch.int32, device=board.device)
    counts = torch.empty((2, B), dtype=torch.int32, device=board.device)
    if B:
        args = [a for t, s in zip((board, stm, ep, castling), strides) for a in (t.data_ptr(), s)]
        _launch("generate_moves", sym, board.device, *args, *opt, moves.data_ptr(),
                counts[0].data_ptr(), counts[1].data_ptr(), B)
    return moves, counts[0], counts[1]


def make_move(board: torch.Tensor, stm: torch.Tensor, ep: torch.Tensor,
              castling: torch.Tensor, halfmove: torch.Tensor, extra: torch.Tensor,
              move: torch.Tensor, variant: str = "standard"):
    """K10: the parent board (B, 64), stm/ep/halfmove (B,), castling
    (B, 4), variant words extra (B, 12) (the fields of ops/board.py's
    Board, in order) and move (B,) (from | to<<6 | promo<<12, >= 0) —
    int32, rows may be strided views — → (child rows (B, BT_W), codes,
    sqs, signs (B, 4)) int32, under the device variant's rules."""
    B = board.shape[0]
    sym = _variant_symbol("make_move", variant)
    fields = (("board", board, (B, 64)), ("stm", stm, (B,)), ("ep", ep, (B,)),
              ("castling", castling, (B, 4)), ("halfmove", halfmove, (B,)),
              ("extra", extra, (B, 12)), ("move", move, (B,)))
    args = [a for name, t, shape in fields for a in (t.data_ptr(), _check_rows(t, name, shape))]
    child = torch.empty((B, BT_W), dtype=torch.int32, device=board.device)
    changes = torch.empty((3, B, 4), dtype=torch.int32, device=board.device)
    if B:
        _launch("make_move", sym, child.device, *args, child.data_ptr(),
                *[c.data_ptr() for c in changes], B)
    return child, changes[0], changes[1], changes[2]


def _claim_words(device: torch.device, n: int) -> torch.Tensor:
    """The stores' per-slot claim words for a table of n rows on `device`
    → (2, n) int32: K11's interior store's words, then its leaf store's
    (K6 claims through the first and reads through the second). All -1
    between launches (a store's winners reset theirs), so one buffer,
    grown to the largest table, serves every table of the launches on one
    stream. Launches on separate streams (the shards of parallel/mesh.py)
    may run at once, so each stream has its own."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    words = _claims.get(key)
    if words is None or words.shape[0] < 2 * n:
        words = _claims[key] = torch.full((2 * n,), -1, dtype=torch.int32, device=device)
    return words[:2 * n].view(2, n)


def _segment_net(params):
    """K11's net arguments → (entry tag, its nine weight pointers,
    (L1, H1, H2), the tensors they point into). board768 nets (f32, bf16
    or int8) take the shipped net's widths SEGMENT_L1 (K3's column layout),
    SEGMENT_H1 and SEGMENT_H2 (K2's body compiled for them), king-bucketed
    nets (K12's body; f32, bf16 or int8) and imported Stockfish nets
    (K13's) an even L1 up to MAX_L1; the weight slots a net does not fill
    are null."""
    from .models import nnue

    kind = nnue.net_kind(params)
    if kind == nnue.STOCKFISH:
        l1, ptrs = _sf_weights(params)
        return "sf", ptrs, (l1, 0, 0), [(f, getattr(params, f)) for f in SF_FIELDS]
    tensors = list(zip(params._fields, params))
    if kind == nnue.KING:
        tag, widths, ptrs = _kb_weights(params)
        return "kb_" + tag, ptrs + [None], widths, tensors
    tag, _, widths = _head_types(params)
    if widths != SHIPPED_WIDTHS:
        raise ValueError(f"K11 takes a board768 net of the shipped widths {SHIPPED_WIDTHS}, "
                         f"got {widths}")
    _check_ft(params, 768, SEGMENT_L1)
    return tag, [t.data_ptr() for t in params] + [None], widths, tensors


def segment_scratch_words(B: int, tag: str, l1: int) -> int:
    """K11's int32 scratch words at B lanes: the stores' staged rows and
    the live flags, and on a Stockfish net (entry tag "sf") its spread
    evals' control words, job records and eval buffers."""
    words = B * SEGMENT_SCRATCH + 4
    if tag == "sf":
        words += SF_CTL_W + B * (SF_JOB_W + sf_buffer_floats(l1))
    return words


def search_segment(params, state, steps: int, pruning: bool, table=None,
                   deep_tt: bool = False, prefer_deep: bool = False, gen=0,
                   variant: str = "standard", out=None) -> torch.Tensor:
    """K11: up to `steps` lockstep search steps of every lane of `state`
    (ops/search.py SearchState on the card, updated in place), stopping
    once every lane is DONE, with the TT runner around each step when
    `table` ((n, 4) int32, updated in place) is given → the packed
    (B+1, 4) int32 summary (done, nodes, root score, root move; row B the
    step count). params: a board768 net (f32, bf16 or int8; K2's and K3's
    bodies, in atomic K1's and K2's), a king-bucketed one (K12's body) or
    an imported Stockfish net (K13's); the state's `acc` has the net's L1
    and accumulator dtype, and only a board768 net outside atomic reads
    or writes it. gen: an int or a
    (B,) int32 CUDA tensor of generations for the prefer_deep store.
    variant: the device variant (each has its own instantiations). out:
    None, or the contiguous (B+1, 4) int32 tensor on the state's device
    to write the summary into (a shard's rows of parallel/mesh.py's
    stacked summary). One launch on the current stream (cooperative, or
    one thread-block cluster where the grid fits in one); raises if the
    card refuses it."""
    from .ops.movegen import max_moves_for

    B, p1, max_moves, l1 = _check_state(state)
    p = p1 - 1
    if max_moves != max_moves_for(variant):
        raise ValueError(f"K11 takes {max_moves_for(variant)}-move lists in {variant}, "
                         f"got {max_moves}")
    if not 1 <= p <= SEGMENT_MAX_PLY:
        raise ValueError(f"K11 takes MAX_PLY 1..{SEGMENT_MAX_PLY}, got {p}")
    adt = NET_TYPES[params.ft_w.dtype][2] if params.ft_w.dtype in NET_TYPES else None
    if state.acc.dtype != adt:
        raise TypeError(f"acc must be {adt} for a net of {params.ft_w.dtype}, got "
                        f"{state.acc.dtype}")
    _check_devices(state)
    tag, ptrs, widths, tensors = _segment_net(params)
    sym = _variant_symbol(f"search_segment_{tag}", variant)
    if l1 != widths[0]:
        raise ValueError(f"acc has L1 {l1}, the net {widths[0]}")
    dev = state.lane.device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"the net's {name} is on {t.device}, the state on {dev}")
    n_rows, claims = 0, None
    if table is not None:
        n_rows = _check_table(table)
        if table.device != dev:
            raise ValueError(f"the table is on {table.device}, the state on {dev}")
        claims = _claim_words(dev, n_rows)
    gen_ptr, gen_int = None, 0
    if torch.is_tensor(gen):
        _check(gen, "gen", torch.int32, (B,))
        gen_ptr = gen.data_ptr()
    else:
        gen_int = int(gen)
    steps = max(0, min(int(steps), 2**31 - 1))
    if out is None:
        out = torch.empty((B + 1, 4), dtype=torch.int32, device=dev)
    _check(out, "out", torch.int32, (B + 1, 4))
    if out.device != dev:
        raise ValueError(f"out is on {out.device}, the state on {dev}")
    if not B:  # no lane: no step
        return out.zero_()
    counts = _body_calls.get(dev.index)
    if counts is None:
        counts = _body_calls[dev.index] = torch.zeros(len(K11_COUNTERS), dtype=torch.int64,
                                                      device=dev)
    from .ops.tt import tables as zobrist_tables

    z1, z2 = zobrist_tables(dev)
    scratch = torch.empty(segment_scratch_words(B, tag, widths[0]), dtype=torch.int32,
                          device=dev)
    grid = ctypes.c_int(0)
    _launch("search_segment", sym, dev,
            *[t.data_ptr() for t in state], *ptrs,
            z1.data_ptr(), z2.data_ptr(),
            None if table is None else table.data_ptr(), n_rows,
            None if claims is None else claims.data_ptr(), gen_ptr, gen_int,
            scratch.data_ptr(), counts.data_ptr(), out.data_ptr(),
            B, p, MAX_HIST, steps, int(bool(pruning)), int(bool(deep_tt)),
            int(bool(prefer_deep)), *widths, ctypes.addressof(grid))
    LAST_GRID["blocks"] = grid.value
    return out


def nnue_stack_backward(acc: torch.Tensor, stm: torch.Tensor, bucket: torch.Tensor,
                        d_pred: torch.Tensor, params, grad: torch.Tensor) -> torch.Tensor:
    """K14: acc (B, 2, 64) f32, stm/bucket (B,) int32, d_pred (B,) f32 the
    loss's gradient by each score, params an f32 net (board768 or
    king-bucketed; its ft_w is not read) whose layer stack has the shipped
    widths → d_acc (B, 2, 64) f32; writes the gradients of l1_w,
    l1_b, l2_w, l2_b, out_w and out_b, field after field, into grad
    (STACK_GRADS,) f32 (a contiguous view, overwritten)."""
    B = acc.shape[0]
    tag, _, widths = _head_types(params)
    if tag != "f32" or widths != SHIPPED_WIDTHS:
        raise ValueError(f"K14 takes an f32 net of the shipped widths {SHIPPED_WIDTHS}, "
                         f"got {tag} {widths}")
    _check(acc, "acc", torch.float32, (B, 2, SEGMENT_L1))
    _check(stm, "stm", torch.int32, (B,))
    _check(bucket, "bucket", torch.int32, (B,))
    _check(d_pred, "d_pred", torch.float32, (B,))
    _check(grad, "grad", torch.float32, (STACK_GRADS,))
    d_acc = torch.empty_like(acc)
    scratch = torch.empty((B, STACK_SCRATCH_W), dtype=torch.float32, device=acc.device)
    _launch("nnue_stack_backward", "nnue_stack_backward", acc.device,
            acc.data_ptr(), stm.data_ptr(), bucket.data_ptr(), d_pred.data_ptr(),
            *[t.data_ptr() for t in params[2:]], d_acc.data_ptr(), grad.data_ptr(),
            scratch.data_ptr(), B)
    return d_acc


def nnue_ft_backward_768(d_acc: torch.Tensor, boards: torch.Tensor, grad: torch.Tensor,
                         stages: int = 7) -> None:
    """K15: d_acc (B, 2, L1) f32, boards (B, 64) int32 → writes ft_w's
    gradient (768, L1) and then ft_b's (L1,) into grad ((768 + 1) * L1,)
    f32 (a contiguous view, overwritten); B >= 1, L1 up to MAX_L1.
    Deterministic: every row sums in (sample, perspective) order, without
    float atomics (csrc/ft_backward.cuh). Its scratch is _ft_backward's.
    stages (for timing a pass alone, on at most FT_WINDOW / 2 samples): 1
    the mark pass, 2 the row pass, 4 the sum and ft_b passes, each called
    after the one before; 7 the gradient."""
    _ft_backward("nnue_ft_backward_768", 768, d_acc, boards, grad, stages)


def adam_update(params: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                lr: float, b1: float, b2: float, eps: float, bc1: float, bc2: float) -> None:
    """K16: one Adam step over the flat (n,) f32 buffers, IN PLACE on
    params, mu and nu; bc1 and bc2 are the f32 bias corrections
    1 - b1**count and 1 - b2**count. Each constant is rounded to f32 once
    (1 - b1 and 1 - b2 from their float64 values, as optax's weak-typed
    scalars are)."""
    n = params.shape[0]
    for name, t in (("params", params), ("grad", grad), ("mu", mu), ("nu", nu)):
        _check(t, name, torch.float32, (n,))
    if n:
        _launch("adam_update", "adam_update", params.device, params.data_ptr(),
                grad.data_ptr(), mu.data_ptr(), nu.data_ptr(), n, -lr, b1, 1 - b1, b2,
                1 - b2, eps, bc1, bc2)


def nnue_refresh_kb(boards: torch.Tensor, ft_w: torch.Tensor, ft_b: torch.Tensor) -> torch.Tensor:
    """K17: a king-bucketed f32 net's HalfKAv2_hm accumulators of boards
    (B, 64) int32 → acc (B, 2, L1) f32; ft_w (NUM_FEATURES, L1) and ft_b
    (L1,) may be a tp shard's column block (any L1 up to MAX_L1, at any
    offset: 16-byte loads where L1 and the pointers allow, else one
    column a thread)."""
    B, l1 = boards.shape[0], ft_w.shape[1]
    _check(boards, "boards", torch.int32, (B, 64))
    _check(ft_w, "ft_w", torch.float32, (NUM_FEATURES, l1))
    _check(ft_b, "ft_b", torch.float32, (l1,))
    if not 0 < l1 <= MAX_L1:
        raise ValueError(f"L1 {l1} is outside the kernel's 1..{MAX_L1} columns")
    acc = torch.empty((B, 2, l1), dtype=torch.float32, device=boards.device)
    if B:
        _launch("nnue_refresh_kb", "nnue_refresh_kb", boards.device, boards.data_ptr(),
                ft_w.data_ptr(), ft_b.data_ptr(), acc.data_ptr(), B, l1)
    return acc


def nnue_ft_backward_kb(d_acc: torch.Tensor, boards: torch.Tensor, grad: torch.Tensor,
                        stages: int = 7) -> None:
    """K18: d_acc (B, 2, L1) f32, boards (B, 64) int32 → writes a
    king-bucketed net's ft_w gradient (NUM_FEATURES, L1) and then ft_b's
    (L1,) into grad ((NUM_FEATURES + 1) * L1,) f32 (a contiguous view,
    overwritten); as K15 otherwise (nnue_ft_backward_768)."""
    _ft_backward("nnue_ft_backward_kb", NUM_FEATURES, d_acc, boards, grad, stages)


def _ft_backward(kernel: str, rows: int, d_acc: torch.Tensor, boards: torch.Tensor,
                 grad: torch.Tensor, stages: int) -> None:
    """K15's or K18's launch. Its scratch, kept a device, stream and feature
    set in _ft_scratch, int32: the bitmap of one window of FT_WINDOW (sample,
    perspective) pairs, FT_WINDOW / 32 words a feature row, then the list
    of the rows the sum pass takes: its count, its finished blocks, two
    spare words and an entry a row (the row, its key count, two spare words
    and its bitmap words): 6.1 MB for K18's 22,528 rows, 209 KB for K15's
    768. Zero between calls: the mark pass sets a row's bits, the row pass
    reads and clears them and lists the rows of more than 4 keys, the last
    block of the sum pass empties the list. Launches on separate streams
    may run at once, so each stream has its own."""
    B, l1 = d_acc.shape[0], d_acc.shape[2]
    _check(d_acc, "d_acc", torch.float32, (B, 2, l1))
    _check(boards, "boards", torch.int32, (B, 64))
    _check(grad, "grad", torch.float32, ((rows + 1) * l1,))
    if not 0 < l1 <= MAX_L1 or not B:
        raise ValueError(f"{kernel} takes a batch and 1..{MAX_L1} columns, got {B} and {l1}")
    if stages != 7 and (stages not in (1, 2, 4) or 2 * B > FT_WINDOW):
        raise ValueError(f"{kernel}: one pass (stages 1, 2 or 4) runs on at most "
                         f"{FT_WINDOW // 2} samples, got stages {stages} at {B}")
    key = (d_acc.device.index, torch.cuda.current_stream(d_acc.device).cuda_stream, rows)
    scratch = _ft_scratch.get(key)
    if scratch is None:
        words = rows * (FT_WINDOW // 32) + 4 + rows * (4 + FT_WINDOW // 32)
        scratch = _ft_scratch[key] = torch.zeros(words, dtype=torch.int32, device=d_acc.device)
    try:
        _launch(kernel, kernel, d_acc.device, d_acc.data_ptr(), boards.data_ptr(),
                grad.data_ptr(), scratch.data_ptr(), B, l1, stages)
    except RuntimeError:  # a refused launch may leave it dirty: the next call starts anew
        del _ft_scratch[key]
        raise
