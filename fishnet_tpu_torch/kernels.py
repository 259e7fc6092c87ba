"""Build, load and launch the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface (`build/kernels-<hash>/lib<name>.so`,
cached by a hash of the sources and flags; all sources build at once, one
nvcc each). The wrappers below take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the output with `torch.empty`,
launch on the current stream, raise if the launch returned an error, and
count the launch. The callers (models/nnue.py, ops/tt.py) send CPU
tensors to their plain PyTorch versions instead; nothing here falls back.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
KERNELS = (
    "nnue_refresh_768", "nnue_forward_from_acc", "nnue_acc_update_768",
    "zobrist_hash",
)

# length of each Zobrist table (ops/tt.py Z_SHAPE; the kernel reads the
# piece-square, en-passant, castling and side-to-move keys at its head)
Z_KEYS = 1409

# launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "nnue_refresh_768_f32": [_P, _P, _P, _P, _I, _I, _P],
    "nnue_refresh_768_i16": [_P, _P, _P, _P, _I, _I, _P],
    "nnue_acc_update_768_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "nnue_acc_update_768_i16": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "nnue_forward_from_acc_f32": [_P] * 10 + [_I, _P],
    "nnue_forward_from_acc_i8": [_P] * 10 + [_I, _P],
    "zobrist_hash": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _P, _I, _P],
}

_lock = threading.Lock()
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
        out = _build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in KERNELS:
            lib = out / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out / f"lib{name}.so.tmp{os.getpid()}"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
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
        for name in KERNELS:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            for sym, argtypes in _SIGNATURES.items():
                if sym.startswith(name):
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[sym] = fn
        _fns.update(fns)
        return time.monotonic() - t0


def _launch(kernel: str, sym: str, *args) -> None:
    if not _fns:
        build()
    stream = torch.cuda.current_stream().cuda_stream
    rc = _fns[sym](*args, stream)
    if rc != 0:
        raise RuntimeError(f"{sym} launch failed: CUDA error {rc}")
    LAUNCHES[kernel] += 1


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _net_types(ft_w: torch.Tensor):
    if ft_w.dtype == torch.float32:
        return "f32", torch.float32
    if ft_w.dtype == torch.int16:
        return "i16", torch.int32
    raise TypeError(f"ft_w must be float32 or int16, got {ft_w.dtype}")


def nnue_refresh_768(boards: torch.Tensor, ft_w: torch.Tensor,
                     ft_b: torch.Tensor) -> torch.Tensor:
    """K1: boards (B, 64) int32 → acc (B, 2, L1) (f32, or int32 for the
    int8 net)."""
    B, l1 = boards.shape[0], ft_w.shape[1]
    tag, adt = _net_types(ft_w)
    _check(boards, "boards", torch.int32, (B, 64))
    _check(ft_w, "ft_w", ft_w.dtype, (768, l1))
    _check(ft_b, "ft_b", adt, (l1,))
    if not 0 < l1 <= 256:
        raise ValueError(f"L1 {l1} is outside the kernel's 1..256 columns")
    acc = torch.empty((B, 2, l1), dtype=adt, device=boards.device)
    if B:
        _launch("nnue_refresh_768", f"nnue_refresh_768_{tag}",
                boards.data_ptr(), ft_w.data_ptr(), ft_b.data_ptr(),
                acc.data_ptr(), B, l1)
    return acc


def nnue_acc_update_768(acc: torch.Tensor, codes: torch.Tensor,
                        sqs: torch.Tensor, signs: torch.Tensor,
                        ft_w: torch.Tensor) -> torch.Tensor:
    """K3: acc (B, 2, L1), codes/sqs/signs (B, 4) int32 → the updated
    (B, 2, L1) accumulators (a new tensor)."""
    B, l1 = acc.shape[0], ft_w.shape[1]
    tag, adt = _net_types(ft_w)
    _check(acc, "acc", adt, (B, 2, l1))
    for name, t in (("codes", codes), ("sqs", sqs), ("signs", signs)):
        _check(t, name, torch.int32, (B, 4))
    _check(ft_w, "ft_w", ft_w.dtype, (768, l1))
    if not 0 < l1 <= 256:
        raise ValueError(f"L1 {l1} is outside the kernel's 1..256 columns")
    out = torch.empty_like(acc)
    if B:
        _launch("nnue_acc_update_768", f"nnue_acc_update_768_{tag}",
                acc.data_ptr(), codes.data_ptr(), sqs.data_ptr(),
                signs.data_ptr(), ft_w.data_ptr(), out.data_ptr(), B, l1)
    return out


def nnue_forward_from_acc(acc: torch.Tensor, stm: torch.Tensor,
                          bucket: torch.Tensor, params) -> torch.Tensor:
    """K2: acc (B, 2, 64), stm/bucket (B,) int32 → eval (B,) f32, for
    the shipped net's widths (L1 64, 8 buckets of 128→16→32→1)."""
    B = acc.shape[0]
    if params.ft_w.dtype == torch.float32:
        tag, adt, wdt, bdt = "f32", torch.float32, torch.float32, torch.float32
    elif params.ft_w.dtype == torch.int16:
        tag, adt, wdt, bdt = "i8", torch.int32, torch.int8, torch.int32
    else:
        raise TypeError(f"unsupported net dtype {params.ft_w.dtype}")
    _check(acc, "acc", adt, (B, 2, 64))
    _check(stm, "stm", torch.int32, (B,))
    _check(bucket, "bucket", torch.int32, (B,))
    for name, shape, dt in (
        ("l1_w", (8, 128, 16), wdt), ("l1_b", (8, 16), bdt),
        ("l2_w", (8, 16, 32), wdt), ("l2_b", (8, 32), bdt),
        ("out_w", (8, 32), wdt), ("out_b", (8,), bdt),
    ):
        _check(getattr(params, name), name, dt, shape)
    out = torch.empty((B,), dtype=torch.float32, device=acc.device)
    if B:
        _launch("nnue_forward_from_acc", f"nnue_forward_from_acc_{tag}",
                acc.data_ptr(), stm.data_ptr(), bucket.data_ptr(),
                params.l1_w.data_ptr(), params.l1_b.data_ptr(),
                params.l2_w.data_ptr(), params.l2_b.data_ptr(),
                params.out_w.data_ptr(), params.out_b.data_ptr(),
                out.data_ptr(), B)
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


def zobrist_hash(board: torch.Tensor, stm: torch.Tensor, ep: torch.Tensor,
                 castling: torch.Tensor, z1: torch.Tensor,
                 z2: torch.Tensor) -> torch.Tensor:
    """K4: board (B, 64), stm/ep (B,), castling (B, 4) — int32, rows may
    be strided views — → (B, 2) int32 key bit patterns."""
    B = board.shape[0]
    sb = _check_rows(board, "board", (B, 64))
    ss = _check_rows(stm, "stm", (B,))
    se = _check_rows(ep, "ep", (B,))
    sc = _check_rows(castling, "castling", (B, 4))
    _check(z1, "z1", torch.int32, (Z_KEYS,))
    _check(z2, "z2", torch.int32, (Z_KEYS,))
    out = torch.empty((B, 2), dtype=torch.int32, device=board.device)
    if B:
        _launch("zobrist_hash", "zobrist_hash",
                board.data_ptr(), sb, stm.data_ptr(), ss, ep.data_ptr(), se,
                castling.data_ptr(), sc, z1.data_ptr(), z2.data_ptr(),
                out.data_ptr(), B)
    return out
