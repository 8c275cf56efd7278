"""K2: per-row top-8 values and lanes of a ``(R, 128)`` float32 array.

Replaces ``extract_candidates_pallas`` (``magellanmapper_tpu/ops/
pallas_kernels.py:159``), the candidate harvest of the unfused peak route
(``ops/peaks.py:205-210``). Each row gives what 8 rounds of masked argmax
give: the largest value and its lane, the lower lane on equal values, that
lane then set to -inf; once only -inf is left, every further slot is
``(-inf, 0)``. Inputs hold no NaN. The CUDA kernel
(``csrc/extract_candidates.cu``) must equal the plain version bit for bit,
values and lanes.

K2 stays its own kernel rather than a mode of K1: K1 returns every peak of
a cube, while this route's contract is at most 8 per 128-lane group in a
round-major order, which decides which plateau peaks survive.
"""

from __future__ import annotations

from typing import Tuple

import torch

from magellanmapper_torch import device as dev
from magellanmapper_torch.kernels import _build

SOURCE = "magellanmapper_torch/csrc/extract_candidates.cu"
REPLACES = "magellanmapper_tpu/ops/pallas_kernels.py:159"

#: lanes per row and rounds (candidates per row)
GROUP = 128
ROUNDS = 8


def extract_candidates_plain(
        rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's jnp loop
    (``ops/peaks.py:212-221``); ``torch.argmax`` returns the first
    maximum."""
    lane = torch.arange(rows.shape[1], device=rows.device)
    work = rows
    vals, lanes = [], []
    for _ in range(ROUNDS):
        vals.append(torch.max(work, dim=1).values)
        a = torch.argmax(work, dim=1)
        lanes.append(a)
        work = torch.where(lane == a[:, None], float("-inf"), work)
    return (torch.stack(vals, dim=1),
            torch.stack(lanes, dim=1).to(torch.int32))


def _launch(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if rows.dim() != 2 or rows.shape[1] != GROUP:
        raise ValueError(
            f"extract_candidates kernel takes (R, {GROUP}) rows, got "
            f"{tuple(rows.shape)}")
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise TypeError(
            "extract_candidates kernel takes contiguous float32 rows")
    if rows.data_ptr() % 16:
        raise ValueError("extract_candidates kernel needs 16-byte aligned "
                         "rows (one float4 load per lane)")
    r = rows.shape[0]
    if r >= 2 ** 33:
        raise ValueError(f"too many rows for one launch: {r}")
    vals = torch.empty((r, ROUNDS), dtype=torch.float32, device=rows.device)
    lanes = torch.empty((r, ROUNDS), dtype=torch.int32, device=rows.device)
    lib = _build.library()
    with _build.on_device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mm_extract_candidates(
            rows.data_ptr(), r, vals.data_ptr(), lanes.data_ptr(), stream)
    _build.check(err, "mm_extract_candidates")
    dev.count_launch("extract_candidates")
    return vals, lanes


def extract_candidates(
        rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-8 ``(values, lanes)`` of each ``(R, 128)`` row, each
    ``(R, 8)``: values descending (float32), lanes int32.

    A CUDA tensor runs the kernel (contiguous float32), a CPU tensor the
    plain version.
    """
    if rows.device.type == "cuda":
        return _launch(rows)
    if rows.device.type == "cpu":
        return extract_candidates_plain(rows)
    raise ValueError(f"unsupported device {rows.device}")
