"""fishnet-tpu's lockstep batched search, written in PyTorch for one
NVIDIA H100.

The layout mirrors the JAX package it was ported from: `chess/` (host
rules), `ops/` (device board, move generation, Zobrist hash, search),
`models/` (the NNUE net), `engine/` (chunks in, responses out). The
device work that the JAX package left to XLA runs here as batched
PyTorch tensor code plus hand-written CUDA kernels (`csrc/`, built and
bound by `kernels.py`). Entry points run on the card unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper runs its plain
PyTorch version instead.
"""
