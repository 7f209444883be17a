"""Probe P1: does a dynamic, even unaligned, window offset into a staged span
cost anything? (Port of ``tools/dynslice_probe.py``; the kernel is
``csrc/dynslice_probe.cu`` ``dynslice_probe_kernel``.)

Each of NBLK programs owns 128 rows in G = 4 groups of 32 and a span block
of SPAN = 1024 lanes; group g sums ``dx * d2`` (``d2 < 100``) of its rows'
``(x, y)`` against a window of W = 128 lanes of span rows 0-1 at an offset
set by the mode:

  static         (g * 160) // 128 * 128    (baseline)
  dyn_aligned    (offs[g, i] // 128) * 128
  dyn_unaligned  offs[g, i]

Inputs are those of the JAX probe: numpy ``default_rng(0)`` rows
(NBLK * 128, 8), ``default_rng(1)`` span (8, NBLK * SPAN), ``default_rng(2)``
offsets (G, NBLK) in ``[0, SPAN - W)``, all float32 / int32. Output
(NBLK * 128, 1) float32.

The kernel walks one program per warp at a time (4 rows per thread);
``launch_shape`` sets its grid, and P2's.

    python -m hipsc_abm_tpu_torch.tools.dynslice_probe [--device cpu] [modes]

prints ``mode  ms  (Glanes/s)`` per mode, as the JAX probe does, timed over
REPS calls (CUDA events on the card).
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.tools import parse_args, time_ms

NBLK = 4096      # programs
SPAN = 1024      # lanes of span data per program
G = 4            # row groups per block
ROWS = 32        # rows per group
W = 128          # window lanes
REPS = 30
MODES = ("static", "dyn_aligned", "dyn_unaligned")
# the kernels' grid: warps (one program in flight each) per block; and the
# warps P1's grid puts on each SM: 32, so that on an H100 (132 SMs) every
# one of the 4096 programs has a warp of its own, all resident at once
WARPS_PER_BLOCK = 4
WARPS_PER_SM = 32


def make_inputs(nblk: int = NBLK, device="cuda", offset: int | None = None):
    """``(offs (G, nblk) int32, rows (nblk * 128, 8), span (8, nblk * SPAN))``
    from the JAX probe's seeds; ``offset`` sets every window offset to that
    lane instead (the edge cases the tests hold)."""
    rows = np.random.default_rng(0).random((nblk * G * ROWS, 8)).astype(np.float32)
    span = np.random.default_rng(1).random((8, nblk * SPAN)).astype(np.float32)
    offs = np.random.default_rng(2).integers(0, SPAN - W, (G, nblk)).astype(np.int32)
    if offset is not None:
        offs[:] = offset
    return tuple(torch.from_numpy(a).to(device) for a in (offs, rows, span))


def launch_shape(nblk: int, n_sm: int, warps_per_sm: int) -> tuple:
    """``(blocks, threads, buffers)`` of a probe kernel's launch over
    ``nblk`` programs on ``n_sm`` SMs: ``warps_per_sm`` warps on each SM (or
    one per program, if fewer), warp w walking programs w, w + warps, ...
    A warp that walks more than one program stages the next one's lanes in
    a second buffer while it walks the current one. At the probes' 4096
    programs on 132 SMs no SM walks more than 32: P1 (32 warps per SM) one
    per warp, P2 (8) 3-4 per warp."""
    nblk = max(nblk, 1)
    blocks = -(-min(nblk, n_sm * warps_per_sm) // WARPS_PER_BLOCK)
    return blocks, 32 * WARPS_PER_BLOCK, 2 if nblk > blocks * WARPS_PER_BLOCK else 1


def window_offsets(mode: str, offs: torch.Tensor) -> torch.Tensor:
    """(G, nblk) int64 lane offset of each group's window in its span block."""
    offs = offs.to(torch.int64)
    if mode == "static":
        g = torch.arange(G, dtype=torch.int64, device=offs.device)
        return ((g * 160) // 128 * 128)[:, None].expand_as(offs)
    if mode == "dyn_aligned":
        return offs // 128 * 128
    if mode == "dyn_unaligned":
        return offs
    raise ValueError(f"unknown mode {mode!r}")


def probe_plain(offs, rows, span, mode: str, chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch probe, ``chunk`` programs at a time."""
    nblk = offs.shape[1]
    off = window_offsets(mode, offs).t()  # (nblk, G)
    lane = torch.arange(W, dtype=torch.int64, device=rows.device)
    out = torch.empty((nblk * G * ROWS,), dtype=torch.float32, device=rows.device)
    for b0 in range(0, nblk, chunk):
        b1 = min(nblk, b0 + chunk)
        blk = torch.arange(b0, b1, dtype=torch.int64, device=rows.device)
        idx = blk[:, None, None] * SPAN + off[b0:b1, :, None] + lane  # (nb, G, W)
        cx, cy = span[0][idx][:, :, None, :], span[1][idx][:, :, None, :]
        r = rows[b0 * G * ROWS:b1 * G * ROWS].view(b1 - b0, G, ROWS, 8)
        dx = r[..., 0:1] - cx
        dy = r[..., 1:2] - cy
        d2 = dx * dx + dy * dy
        acc = torch.where(d2 < 100.0, dx * d2, torch.zeros_like(d2)).sum(dim=-1)
        out[b0 * G * ROWS:b1 * G * ROWS] = acc.reshape(-1)
    return out[:, None]


def probe_cuda(offs, rows, span, mode: str) -> torch.Tensor:
    """The probe. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if rows.device.type == "cpu":
        return probe_plain(offs, rows, span, mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    nblk = offs.shape[1] if offs.dim() == 2 else 0
    kernels.check_cuda("offs", offs, torch.int32, (G, nblk))
    kernels.check_cuda("rows", rows, torch.float32, (nblk * G * ROWS, 8))
    kernels.check_cuda("span", span, torch.float32, (8, nblk * SPAN))
    out = torch.empty((nblk * G * ROWS, 1), dtype=torch.float32, device=rows.device)
    shape = launch_shape(nblk, kernels.device_limits()["n_sm"], WARPS_PER_SM)
    kernels.launch("hipsc_dynslice_probe", offs.data_ptr(), rows.data_ptr(),
                   span.data_ptr(), out.data_ptr(), nblk, MODES.index(mode), *shape)
    kernels.launch_counts["dynslice_probe"] += 1
    return out


def lanes(nblk: int = NBLK) -> int:
    """(row, lane) pairs one call evaluates."""
    return nblk * G * ROWS * W


def run(mode: str, device="cuda", nblk: int = NBLK, reps: int = REPS) -> dict:
    """Time one mode and print the JAX probe's line."""
    dev = torch.device(device)
    offs, rows, span = make_inputs(nblk, dev)
    dt = time_ms(lambda: probe_cuda(offs, rows, span, mode), reps, dev)
    print(f"{mode:14s} {dt:8.3f} ms  ({lanes(nblk) / dt / 1e6:.1f} Glanes/s)")
    return dict(mode=mode, ms=dt, glanes_per_s=lanes(nblk) / dt / 1e6)


def main(argv: Sequence[str] = ()) -> list:
    args = parse_args(argv, MODES, __doc__.splitlines()[0])
    return [run(m, args.device) for m in args.modes]


if __name__ == "__main__":
    main(sys.argv[1:])
