"""Probe P2: a contact-shaped body over windows of (rows x lanes) against a
full-span scan. (Port of ``tools/dynslice_probe2.py``; the kernel is
``csrc/dynslice_probe.cu`` ``dynslice_probe2_kernel``.)

Each of NBLK programs owns B = 128 rows and a span block of SPAN = 512
lanes. The rows are cut into groups of ``rows`` rows, and group g runs
``body`` (14 operations per lane, shaped like the masked contact kernel)
against ``width`` lanes of span rows 0, 1, 2 and 4 starting at
``min((offs[g % 4, i] // 128) * 128, SPAN - width)``:

  full       128 rows x 512 lanes   (one group: the whole span)
  half       2 x (64 rows x 256 lanes)
  q256       4 x (32 rows x 256 lanes)
  quarters   4 x (32 rows x 128 lanes)
  octets     16 x (8 rows x 128 lanes)

Inputs are those of the JAX probe: numpy ``default_rng(0)`` rows
(NBLK * B, 8), ``default_rng(1)`` span (8, NBLK * SPAN), ``default_rng(2)``
offsets (4, NBLK) in ``[0, SPAN - 256)``, all float32 / int32. Output
(NBLK * B, 1) float32. The kernel's grid is P1's
(``dynslice_probe.launch_shape``).

    python -m hipsc_abm_tpu_torch.tools.dynslice_probe2 [--device cpu] [modes]

prints ``mode  ms  Glanes/s  (Mlanes)`` per mode, as the JAX probe does,
timed over REPS calls (CUDA events on the card).
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.tools import dynslice_probe, parse_args, time_ms

NBLK = 4096
SPAN = 512
B = 128
REPS = 30
MODES = ("full", "half", "q256", "quarters", "octets")
# (rows per group, window lanes) of each mode
GROUPS = {"full": (128, 512), "half": (64, 256), "q256": (32, 256),
          "quarters": (32, 128), "octets": (8, 128)}
SPAN_ROWS = (0, 1, 2, 4)  # the span rows the body reads: x, y, f, id
# the warps the kernel's grid puts on each SM: 8, whose two staged buffers
# of 10.6 KB each (169 KB in all) fit the SM's shared memory
WARPS_PER_SM = 8


def make_inputs(nblk: int = NBLK, device="cuda", offset: int | None = None):
    """``(offs (4, nblk) int32, rows (nblk * B, 8), span (8, nblk * SPAN))``
    from the JAX probe's seeds; ``offset`` sets every offset to that lane
    instead (the edge cases the tests hold)."""
    rows = np.random.default_rng(0).random((nblk * B, 8)).astype(np.float32)
    span = np.random.default_rng(1).random((8, nblk * SPAN)).astype(np.float32)
    offs = np.random.default_rng(2).integers(0, SPAN - 256, (4, nblk)).astype(np.int32)
    if offset is not None:
        offs[:] = offset
    return tuple(torch.from_numpy(a).to(device) for a in (offs, rows, span))


def window_offsets(mode: str, offs: torch.Tensor) -> torch.Tensor:
    """(B // rows, nblk) int64 lane offset of each group's window."""
    group, width = GROUPS[mode]
    g = torch.arange(B // group, dtype=torch.int64, device=offs.device)
    return torch.clamp(offs.to(torch.int64)[g % 4] // 128 * 128, max=SPAN - width)


def pair_terms(r, c):
    """The body's per-pair part: rows ``r`` (..., 8) against span lanes
    ``c`` (4, ..., W) of span rows 0, 1, 2, 4. Returns ``(keep, w, dx,
    dy)``, each (..., W)."""
    x, y, f, rid = (r[..., k:k + 1] for k in (0, 1, 2, 4))
    cx, cy, cf, cid = c
    dx = x - cx
    dy = y - cy
    d2 = dx * dx + dy * dy
    in_run = (cf >= f) & (cf < f + 3.0)
    ok = in_run & (d2 < 100.0) & (cid != rid)
    inv = torch.where(d2 > 0, torch.rsqrt(d2), torch.zeros_like(d2))
    m = d2 * inv
    dd = (10.0 - m) * 0.71
    fm = ((-0.02 * dd + 0.49) * dd + 1.08) * dd - 1.3
    keep = ok & (dd > -0.36)
    return keep, fm * inv, dx, dy


def body(r, c):
    """The probe's ``body``: ``fx + fy`` summed over the lanes of ``c``."""
    keep, w, dx, dy = pair_terms(r, c)
    zero = torch.zeros_like(w)
    fx = torch.where(keep, w * dx, zero).sum(dim=-1)
    fy = torch.where(keep, w * dy, zero).sum(dim=-1)
    return fx + fy


def blocks(offs, rows, span, mode: str, chunk: int = 64):
    """Yield ``(b0, b1, r, c)``: the rows (nb, groups, group, 8) and window
    lanes (4, nb, groups, 1, W) of programs ``[b0, b1)``, ``chunk`` at a
    time, as ``body`` takes them (mode full holds 128 x 512 lanes per
    program)."""
    group, width = GROUPS[mode]
    nblk = offs.shape[1]
    off = window_offsets(mode, offs).t()  # (nblk, groups)
    lane = torch.arange(width, dtype=torch.int64, device=rows.device)
    span4 = span[list(SPAN_ROWS)]
    for b0 in range(0, nblk, chunk):
        b1 = min(nblk, b0 + chunk)
        blk = torch.arange(b0, b1, dtype=torch.int64, device=rows.device)
        idx = blk[:, None, None] * SPAN + off[b0:b1, :, None] + lane  # (nb, groups, W)
        c = span4[:, idx][:, :, :, None, :]
        r = rows[b0 * B:b1 * B].view(b1 - b0, B // group, group, 8)
        yield b0, b1, r, c


def probe_plain(offs, rows, span, mode: str) -> torch.Tensor:
    """Plain PyTorch probe, block by block."""
    out = torch.empty((offs.shape[1] * B,), dtype=torch.float32, device=rows.device)
    for b0, b1, r, c in blocks(offs, rows, span, mode):
        out[b0 * B:b1 * B] = body(r, c).reshape(-1)
    return out[:, None]


def probe_cuda(offs, rows, span, mode: str) -> torch.Tensor:
    """The probe. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if rows.device.type == "cpu":
        return probe_plain(offs, rows, span, mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    nblk = offs.shape[1] if offs.dim() == 2 else 0
    kernels.check_cuda("offs", offs, torch.int32, (4, nblk))
    kernels.check_cuda("rows", rows, torch.float32, (nblk * B, 8))
    kernels.check_cuda("span", span, torch.float32, (8, nblk * SPAN))
    out = torch.empty((nblk * B, 1), dtype=torch.float32, device=rows.device)
    shape = dynslice_probe.launch_shape(nblk, kernels.device_limits()["n_sm"], WARPS_PER_SM)
    kernels.launch("hipsc_dynslice_probe2", offs.data_ptr(), rows.data_ptr(),
                   span.data_ptr(), out.data_ptr(), nblk, *GROUPS[mode], *shape)
    kernels.launch_counts["dynslice_probe2"] += 1
    return out


def lanes(mode: str, nblk: int = NBLK) -> int:
    """(row, lane) pairs one call evaluates."""
    return B * GROUPS[mode][1] * nblk


def run(mode: str, device="cuda", nblk: int = NBLK, reps: int = REPS) -> dict:
    """Time one mode and print the JAX probe's line."""
    dev = torch.device(device)
    offs, rows, span = make_inputs(nblk, dev)
    dt = time_ms(lambda: probe_cuda(offs, rows, span, mode), reps, dev)
    n = lanes(mode, nblk)
    print(f"{mode:10s} {dt:8.3f} ms  {n / dt / 1e6:7.1f} Glanes/s  ({n / 1e6:.0f} Mlanes)")
    return dict(mode=mode, ms=dt, glanes_per_s=n / dt / 1e6)


def main(argv: Sequence[str] = ()) -> list:
    args = parse_args(argv, MODES, __doc__.splitlines()[0])
    return [run(m, args.device) for m in args.modes]


if __name__ == "__main__":
    main(sys.argv[1:])
