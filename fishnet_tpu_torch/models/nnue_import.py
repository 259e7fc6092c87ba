"""Stockfish `.nnue` network files (HalfKAv2_hm) in PyTorch: the reader,
the writer and the full evaluation.

A copy of the JAX package's models/nnue_import.py that imports neither
JAX nor that package. The file layout (SFNNv5-era HalfKAv2_hm, as written
by the public nnue-pytorch trainer and read by Stockfish 15/16):

    uint32 version | uint32 net_hash | uint32 len | len x u8 description
    FeatureTransformer:
        uint32 ft_hash
        int16 biases[L1]
        int16 weights[22528 x L1]          (row-major, feature-major)
        int32 psqt_weights[22528 x 8]      (8 PSQT output buckets)
    Network (8 layer stacks, stored bucket by bucket):
        uint32 hash
        per bucket b in 0..8:
            fc_0: int32 biases[16],  int8 weights[16 x L1]
            fc_1: int32 biases[32],  int8 weights[32 x 30]
            fc_2: int32 biases[1],   int8 weights[1 x 32]

Any int16/int8/int32 array section may instead be stored LEB128-
compressed: magic b"COMPRESSED_LEB128" + uint32 byte_count + stream.
Anything that does not match raises UnsupportedNnueFormat.

The arrays are dequantized exactly as the reference does it (a float64
division by the section's scale, then float32), so both packages read
the same file into the same bits. `evaluate_sf` is the net's full eval
(two perspective refreshes of the feature transform and the PSQT table,
the pairwise clipped product, the bucketed fc0 with its skip row, the
squared-clipped fc1, fc2): K13 on the card (csrc/nnue_evaluate_sf.cu,
bound by kernels.py), `evaluate_sf_plain` on the CPU.
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels
from .nnue import (
    NUM_FEATURES, feature_indices, king_square, output_bucket, sum_rows,
)

LEB_MAGIC = b"COMPRESSED_LEB128"
NUM_PSQT_BUCKETS = 8
NUM_STACKS = 8
FC0_OUT = 16  # 15 hidden + 1 skip row
FC1_IN = 30  # 15 clipped + 15 squared-clipped
FC1_OUT = 32

QA = 127.0  # feature-transformer scale (activations 0..127 = 0..1)
QB = 64.0  # hidden-layer weight scale
OUTPUT_SCALE = 16.0  # FV_SCALE: quantized net output / 16 = centipawns
NNUE2SCORE = 600.0  # float-model output +-1 = +-600 cp (nnue-pytorch)
# quantized storage scales (nnue-pytorch serializer):
#   ft w,b              x QA
#   fc0/fc1 w           x QB          fc0/fc1 b x QA*QB
#   fc2 w               x NNUE2SCORE*OUTPUT_SCALE/QA
#   fc2 b, psqt w       x NNUE2SCORE*OUTPUT_SCALE

# the widths _infer_l1 recognises in a raw file (3072: Stockfish's big net)
KNOWN_L1 = (64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072)


class UnsupportedNnueFormat(ValueError):
    pass


ARRAY_FIELDS = (
    "ft_w", "ft_b", "psqt_w",
    "fc0_w", "fc0_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)


@dataclasses.dataclass(frozen=True)
class StockfishNet:
    """A dequantized HalfKAv2_hm net; every array is a float32 tensor."""

    ft_w: torch.Tensor  # (NUM_FEATURES, L1)
    ft_b: torch.Tensor  # (L1,)
    psqt_w: torch.Tensor  # (NUM_FEATURES, 8) pawn-value units
    fc0_w: torch.Tensor  # (8, 16, L1)
    fc0_b: torch.Tensor  # (8, 16)
    fc1_w: torch.Tensor  # (8, 32, 30)
    fc1_b: torch.Tensor  # (8, 32)
    fc2_w: torch.Tensor  # (8, 1, 32)
    fc2_b: torch.Tensor  # (8, 1)
    version: int = 0
    net_hash: int = 0
    description: bytes = b""

    @property
    def l1(self) -> int:
        return self.ft_w.shape[1]

    @property
    def device(self) -> torch.device:
        return self.ft_w.device

    def to(self, device) -> "StockfishNet":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


def stockfish_net_from_numpy(mapping: Mapping[str, np.ndarray], device=None,
                             version: int = 0, net_hash: int = 0,
                             description: bytes = b"") -> StockfishNet:
    """A StockfishNet from float32 numpy arrays under the JAX package's
    StockfishNet field names (its net's arrays carry over bit for bit)."""
    dev = device_mod.resolve(device)
    return StockfishNet(
        **{f: torch.from_numpy(np.array(mapping[f], np.float32)).to(dev) for f in ARRAY_FIELDS},
        version=version, net_hash=net_hash, description=description,
    )


# ------------------------------------------------------------------ LEB128


def _leb128_decode(buf: memoryview, count: int) -> tuple[np.ndarray, int]:
    """Decode `count` signed LEB128 integers → (values, bytes used)."""
    out = np.empty(count, dtype=np.int64)
    pos = 0
    end = len(buf)
    for i in range(count):
        result = 0
        shift = 0
        while True:
            if pos >= end:
                raise UnsupportedNnueFormat("truncated LEB128 stream")
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                if b & 0x40:  # sign-extend
                    result |= -(1 << shift)
                break
        out[i] = result
    return out, pos


def _leb128_encode(values: np.ndarray) -> bytes:
    out = bytearray()
    for v in map(int, values):
        while True:
            b = v & 0x7F
            v >>= 7
            if (v == 0 and not b & 0x40) or (v == -1 and b & 0x40):
                out.append(b)
                break
            out.append(b | 0x80)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def u32(self) -> int:
        if self.pos + 4 > len(self.data):
            raise UnsupportedNnueFormat("truncated file")
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def bytes(self, n: int) -> bytes:
        b = bytes(self.data[self.pos:self.pos + n])
        if len(b) != n:
            raise UnsupportedNnueFormat("truncated file")
        self.pos += n
        return b

    def array(self, dtype, count: int) -> np.ndarray:
        """Read `count` values, either raw little-endian or a LEB128 block."""
        magic_len = len(LEB_MAGIC)
        if bytes(self.data[self.pos:self.pos + magic_len]) == LEB_MAGIC:
            self.pos += magic_len
            nbytes = self.u32()
            values, used = _leb128_decode(self.data[self.pos:], count)
            if used != nbytes:
                raise UnsupportedNnueFormat(
                    f"LEB128 block length mismatch: header {nbytes}, used {used}")
            self.pos += used
            info = np.iinfo(dtype)
            if values.min() < info.min or values.max() > info.max:
                raise UnsupportedNnueFormat("LEB128 value out of dtype range")
            return values.astype(dtype)
        itemsize = np.dtype(dtype).itemsize
        raw = self.bytes(count * itemsize)
        return np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<")).astype(dtype)

    def eof(self) -> bool:
        return self.pos == len(self.data)


# ------------------------------------------------------------------- parse


def _infer_l1(total: int, header_end: int) -> int:
    """L1 from the size of a raw (uncompressed) file of this layout."""
    body = total - header_end
    for l1 in KNOWN_L1:
        ft = 4 + 2 * l1 + 2 * NUM_FEATURES * l1 + 4 * NUM_FEATURES * NUM_PSQT_BUCKETS
        stacks = 4 + NUM_STACKS * (
            4 * FC0_OUT + FC0_OUT * l1 + 4 * FC1_OUT + FC1_OUT * FC1_IN + 4 + FC1_OUT)
        if ft + stacks == body:
            return l1
    raise UnsupportedNnueFormat(
        f"cannot infer L1 from file size {total} (compressed files carry "
        "explicit block lengths; raw files must match a known L1)")


def load_nnue(path, l1: int | None = None, device=None) -> StockfishNet:
    """Parse a `.nnue` file into a dequantized float32 net on `device`
    (default: the card; pass device="cpu" for the CPU)."""
    dev = device_mod.resolve(device)
    data = Path(path).read_bytes()
    r = _Reader(data)
    version = r.u32()
    net_hash = r.u32()
    desc_len = r.u32()
    if desc_len > 4096:
        raise UnsupportedNnueFormat(f"implausible description length {desc_len}")
    description = r.bytes(desc_len)

    r.u32()  # ft_hash: checked only through the sizes that follow
    if l1 is None:
        try:
            l1 = _infer_l1(len(data), r.pos - 4)
        except UnsupportedNnueFormat:
            if LEB_MAGIC in data:  # compressed sections shrink the file
                raise UnsupportedNnueFormat("pass l1= explicitly for compressed files") from None
            raise
    if l1 % 2:
        raise UnsupportedNnueFormat("L1 must be even (pairwise activation)")

    ft_b = r.array(np.int16, l1)
    ft_w = r.array(np.int16, NUM_FEATURES * l1).reshape(NUM_FEATURES, l1)
    psqt = r.array(np.int32, NUM_FEATURES * NUM_PSQT_BUCKETS).reshape(
        NUM_FEATURES, NUM_PSQT_BUCKETS)

    r.u32()  # the layer stacks' hash
    fc0_w = np.empty((NUM_STACKS, FC0_OUT, l1), np.float32)
    fc0_b = np.empty((NUM_STACKS, FC0_OUT), np.float32)
    fc1_w = np.empty((NUM_STACKS, FC1_OUT, FC1_IN), np.float32)
    fc1_b = np.empty((NUM_STACKS, FC1_OUT), np.float32)
    fc2_w = np.empty((NUM_STACKS, 1, FC1_OUT), np.float32)
    fc2_b = np.empty((NUM_STACKS, 1), np.float32)
    for b in range(NUM_STACKS):
        fc0_b[b] = r.array(np.int32, FC0_OUT) / (QA * QB)
        fc0_w[b] = r.array(np.int8, FC0_OUT * l1).reshape(FC0_OUT, l1) / QB
        fc1_b[b] = r.array(np.int32, FC1_OUT) / (QA * QB)
        fc1_w[b] = r.array(np.int8, FC1_OUT * FC1_IN).reshape(FC1_OUT, FC1_IN) / QB
        fc2_b[b] = r.array(np.int32, 1) / (NNUE2SCORE * OUTPUT_SCALE)
        fc2_w[b] = r.array(np.int8, FC1_OUT).reshape(1, FC1_OUT) / (
            NNUE2SCORE * OUTPUT_SCALE / QA)
    if not r.eof():
        raise UnsupportedNnueFormat(
            f"{len(data) - r.pos} trailing bytes after last layer stack")

    arrays = dict(
        ft_w=(ft_w / QA).astype(np.float32),
        ft_b=(ft_b / QA).astype(np.float32),
        psqt_w=(psqt / (NNUE2SCORE * OUTPUT_SCALE)).astype(np.float32),
        fc0_w=fc0_w, fc0_b=fc0_b, fc1_w=fc1_w, fc1_b=fc1_b, fc2_w=fc2_w, fc2_b=fc2_b,
    )
    return stockfish_net_from_numpy(arrays, dev, version=version, net_hash=net_hash,
                                    description=description)


def write_nnue(path, net_q: dict, compress_ft: bool = False) -> None:
    """Serialize quantized arrays into the `.nnue` layout (the reference's
    test fixture writer, byte for byte).

    net_q keys: ft_b int16[L1], ft_w int16[NF, L1], psqt int32[NF, 8],
    and per-stack arrays fc0_b/fc0_w/fc1_b/fc1_w/fc2_b/fc2_w; optional
    version, net_hash, description, ft_hash, stack_hash."""
    out = bytearray()
    out += struct.pack("<I", net_q.get("version", 0x7AF32F20))
    out += struct.pack("<I", net_q.get("net_hash", 0x1337))
    desc = net_q.get("description", b"fishnet-tpu synthetic test net")
    out += struct.pack("<I", len(desc)) + desc

    def emit(arr: np.ndarray, compress: bool = False):
        flat = arr.reshape(-1)
        if compress:
            payload = _leb128_encode(flat)
            out.extend(LEB_MAGIC + struct.pack("<I", len(payload)) + payload)
        else:
            out.extend(flat.astype(flat.dtype.newbyteorder("<")).tobytes())

    out += struct.pack("<I", net_q.get("ft_hash", 0x5D69D5B8))
    emit(net_q["ft_b"].astype(np.int16))
    emit(net_q["ft_w"].astype(np.int16).reshape(-1), compress=compress_ft)
    emit(net_q["psqt"].astype(np.int32))
    out += struct.pack("<I", net_q.get("stack_hash", 0x63337156))
    for b in range(NUM_STACKS):
        emit(net_q["fc0_b"][b].astype(np.int32))
        emit(net_q["fc0_w"][b].astype(np.int8))
        emit(net_q["fc1_b"][b].astype(np.int32))
        emit(net_q["fc1_w"][b].astype(np.int8))
        emit(net_q["fc2_b"][b].astype(np.int32))
        emit(net_q["fc2_w"][b].astype(np.int8))
    Path(path).write_bytes(bytes(out))


# --------------------------------------------- K13: the full evaluation


def evaluate_sf_plain(net: StockfishNet, boards: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """K13's plain version: (B, 64) boards, stm (B,) → (B,) f32 scores,
    SFNNv5 semantics: both perspectives' feature transform and PSQT sums
    (nnue.sum_rows' order), the pairwise clipped product (side to move
    first), the output bucket's fc0 (row 15 the skip), the squared-clipped
    fc1, fc2, plus half the side to move's PSQT difference, x NNUE2SCORE."""
    half = net.l1 // 2
    accs, psqts = [], []
    for p in (0, 1):
        idx = feature_indices(boards, p, king_square(boards, p))
        accs.append(net.ft_b + sum_rows(net.ft_w, idx, torch.float32))
        psqts.append(sum_rows(net.psqt_w, idx, torch.float32))
    white = (stm == 0)[:, None]
    own = torch.where(white, accs[0], accs[1])
    opp = torch.where(white, accs[1], accs[0])

    def pairwise(acc):
        c = acc.clamp(0.0, 1.0)
        return c[:, :half] * c[:, half:]

    x = torch.cat([pairwise(own), pairwise(opp)], 1)  # (B, L1)
    b = output_bucket(boards).long()
    h0 = torch.bmm(net.fc0_w[b], x[:, :, None])[:, :, 0] + net.fc0_b[b]  # (B, 16)
    skip = h0[:, 15]
    h = h0[:, :15].clamp(0.0, 1.0)
    h1_in = torch.cat([h, h * h], 1)  # (B, 30)
    h1 = (torch.bmm(net.fc1_w[b], h1_in[:, :, None])[:, :, 0] + net.fc1_b[b]).clamp(0.0, 1.0)
    out = torch.bmm(net.fc2_w[b], h1[:, :, None])[:, 0, 0] + net.fc2_b[b][:, 0]
    diff = torch.where(white, psqts[0] - psqts[1], psqts[1] - psqts[0])
    psqt = diff.gather(1, b[:, None])[:, 0] / 2.0
    return (out + skip + psqt) * NNUE2SCORE


def evaluate_sf(net: StockfishNet, boards: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """K13 wrapper: plain version on the CPU, kernel on the card."""
    if boards.device.type == "cpu":
        return evaluate_sf_plain(net, boards, stm)
    return kernels.nnue_evaluate_sf(boards, stm, net)
