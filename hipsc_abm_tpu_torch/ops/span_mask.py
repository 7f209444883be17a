"""The span-mask contact substeps: CUDA kernels (``csrc/contact_mask.cu``)
and their plain versions.

Port of the span-mask section of ``hipsc_abm_tpu/ops/pallas_contact.py``:
``contact_substep_ids_to_mask`` (B2, the seed), ``contact_substep_masked``
(B1) and ``compact_mask_bonds`` (B3). The physics is that of the id-list
substep (``ops.contact``); what changes is where the bond set lives while the
Verlet window is frozen.

**The mask.** The window is the per-row run bounds (``neighbors.run_bounds``,
(C, 6) int32 in 2D, (C, 18) in 3D) that the contact kernels walk. Candidate
``j`` of sorted row ``i`` is the ``j``-th agent of the concatenation of its
runs (3 in 2D, 9 in 3D), in run
order and ascending sorted position (the row itself included, so that ``j``
depends on the bounds alone). The mask holds one bit per (row, candidate):
"this pair was kept by the last substep". It is ``(W, C)`` int32, word-major
(bit ``j & 31`` of ``mask[j >> 5, i]``), with ``W`` words: in the engine a
static capacity (``EngineConfig.mask_bits / 32``, grown by re-execution when
the widest row's candidate count ``M`` of a build passes it), for a direct
call without a mask buffer ``ceil(M / 32)`` of these bounds (``mask_words``,
a host read). It is valid only while the bounds it was seeded over are
frozen; bits beyond a row's candidates are zero, and so are the bits of
candidates past ``32 W``, which no operation stores (their forces and
degrees still count: the engine's probe of ``M`` re-executes the step
before any result depends on a dropped bit). Bytes: ``4 W C``, so 0.57 MB per word at 100k
cells (C = 143,104 slots) and 2.9 MB per word at 500k (C = 715,008), against
the TPU layout's ``n_runs * span`` int8 bytes per row (1.5 KB at the default
512-lane span: 220 MB and 1.1 GB). In 3D a row's nine runs hold far more
candidates: at the 99k-cell spheroid the widest row has M = 297, so W = 10
and the mask is 5.2 MB (C = 128,768; ``chip_smoke.py`` on an NVIDIA H100
80GB HBM3, 700.00 W).

**The three operations**, all on sorted rows:

- ``contact_seed`` (B2): membership from the (C, K) partner-id lists, the
  only bond form that survives a re-sort; returns force, degree and a fresh
  mask. Runs at the scan's entry and at every rebuild. The kernel tests the
  pair law's break before membership, so it scans the K partner ids only
  for pairs that survive beyond the search radius.
- ``contact_masked`` (B1): membership from the mask; the new keep set is
  written back into the same mask tensor (in place, on both paths).
- ``mask_compact`` (B3): the mask back to (C, K) partner ids, the first K
  set bits in candidate order, ``NO_BOND`` padded. Runs before each re-sort
  and at the scan's exit. More set bits than K truncate; the degree probe of
  the substeps then exceeds K and ``HipscEngine.safe_step`` grows K and
  re-executes the step before any result depends on the truncation.

The kernels take a candidate for the row itself when its sorted position
equals the row's (the plain versions compare ids): live ids are unique, and
rows dead at the window's build have empty runs (``neighbors.run_bounds``),
so the two tests agree on every row the engine gives them. The kernels' walk
therefore reads no ids except at the seed's membership test.

**Predicated launches.** Each operation takes ``pred``, an optional (1,)
int32 tensor on the rows' device: the operation runs only where
``pred[0] != 0`` and otherwise leaves its output buffers as they were. With
``out`` buffers given (``(force, degree, mask)`` for the seed, ``(force,
degree)`` for the masked substep, the (C, K) ids for the compaction) the
results are written into them. The engine's scan launches, on every substep
after the first, the compaction and the seed under "the window is stale"
and the masked substep under its negation, into shared buffers, so that the
choice is made on the device (no host read; a CUDA graph captures both
launches). The plain versions take the same arguments.

Each wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor (or raises); ``kernels.launch_counts`` counts launches
(skipped ones included: the kernel is launched and returns), the 3D forms
under the names with ``_3d`` appended.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.ops import jkr as jkr_ops
from hipsc_abm_tpu_torch.ops import xla_f32
from hipsc_abm_tpu_torch.ops.contact import check_probes, fold_probes, pair_law_args
from hipsc_abm_tpu_torch.ops.neighbors import Grouping, bounds_window, grouping_args, plain_lanes


def candidate_counts(bounds: torch.Tensor) -> torch.Tensor:
    """(C,) int64 candidate count of each row: the summed widths of its runs."""
    b = bounds.to(torch.int64).view(bounds.shape[0], -1, 2)
    return torch.clamp(b[..., 1] - b[..., 0], min=0).sum(dim=1)


def widest_row(bounds: torch.Tensor) -> int:
    """The widest row's candidate count (a host read)."""
    return int(candidate_counts(bounds).max()) if bounds.shape[0] else 0


def mask_words(bounds: torch.Tensor) -> int:
    """Words per row of a mask that holds every candidate of these bounds
    (at least 1; a host read)."""
    return max(1, -(-widest_row(bounds) // 32))


def _skipped(pred: Optional[torch.Tensor]) -> bool:
    """Whether a plain operation's predicate says not to run (a read of a
    CPU tensor)."""
    return pred is not None and not bool(pred.reshape(-1)[0])


def _window(bounds: torch.Tensor, width=None):
    """The padded window of the bounds (``bounds_window``, of ``width``) with
    each entry's candidate index: ``(pos, valid, j)``, all (C, n_runs *
    run width)."""
    pos, valid = bounds_window(bounds, width)
    b = bounds.to(torch.int64).view(bounds.shape[0], -1, 2)
    counts = torch.clamp(b[..., 1] - b[..., 0], min=0)
    first = torch.cumsum(counts, dim=1) - counts  # (C, n_runs) each run's first candidate
    width = pos.shape[1] // b.shape[1]
    k = torch.arange(width, dtype=torch.int64, device=bounds.device)
    j = (first[:, :, None] + k).reshape(pos.shape)
    return pos, valid, j


def _unpack(mask: torch.Tensor, j: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(C, T) bool: bit ``j`` of each row's words, False where not valid or
    past the mask's ``32 W`` bits."""
    words = mask.t().to(torch.int64) & 0xFFFFFFFF  # (C, W)
    w = torch.clamp(j >> 5, max=mask.shape[0] - 1)
    bits = (torch.gather(words, 1, w) >> (j & 31)) & 1
    return (bits == 1) & valid & (j < 32 * mask.shape[0])


def _pack(keep: torch.Tensor, j: torch.Tensor, n_words: int) -> torch.Tensor:
    """(W, C) int32 words with bit ``j`` set for every kept entry within the
    ``32 W`` bits."""
    keep = keep & (j < 32 * n_words)
    vals = torch.where(keep, torch.ones_like(j) << (j & 31), torch.zeros_like(j))
    w = torch.where(keep, j >> 5, torch.zeros_like(j))
    words = torch.zeros((keep.shape[0], n_words), dtype=torch.int64, device=keep.device)
    words.scatter_add_(1, w, vals)  # distinct bits per word: the sum is the OR
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).t().contiguous()


def _substep(xyzr, ids, alive, pos, valid, bonded, law, lanes):
    force, keep = jkr_ops.jkr_substep_aligned(
        bonded, xyzr, ids, alive, None, pos, valid, law["radius"],
        law["adhesion_const"], law["poisson"], law["youngs"], law["break_d"],
        law["uniform_radius"], lanes,
    )
    return force, keep.sum(dim=1, dtype=torch.int32), keep


def _law(radius, adhesion_const, poisson, youngs, break_d, uniform_radius):
    return dict(radius=radius, adhesion_const=adhesion_const, poisson=poisson,
                youngs=youngs, break_d=break_d, uniform_radius=uniform_radius)


def contact_seed_plain(
    xyzr, ids, alive, bounds, partners, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None,
    pred: Optional[torch.Tensor] = None, out=None, width=None,
    grouping: Optional[Grouping] = None, probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain seed substep: returns ``(force (C, 3) float32, degree (C,)
    int32, mask (W, C) int32)``, written into ``out`` when given (``W`` is
    then its mask's, else ``mask_words(bounds)``); ``pred`` as in the module
    docstring; ``width`` is ``neighbors.bounds_window``'s. ``uniform_radius``
    selects the uniform law, None the general law, as in the kernel.
    ``grouping``: the forces' sum order, and ``probes``, folded into where
    the substep runs, as in ``ops.contact.contact_substep_plain``."""
    if out is None:
        C, dev = xyzr.shape[0], xyzr.device
        out = (torch.zeros((C, 3), dtype=torch.float32, device=dev),
               torch.zeros((C,), dtype=torch.int32, device=dev),
               torch.zeros((mask_words(bounds), C), dtype=torch.int32, device=dev))
    if _skipped(pred):
        return out
    pos, valid, j = _window(bounds, width)
    bonded = jkr_ops._is_bonded(partners, ids[pos])
    force, degree, keep = _substep(xyzr, ids, alive, pos, valid, bonded,
                                   _law(radius, adhesion_const, poisson, youngs, break_d,
                                        uniform_radius), plain_lanes(bounds, pos, grouping))
    out[0].copy_(force)
    out[1].copy_(degree)
    out[2].copy_(_pack(keep, j, out[2].shape[0]))
    if probes is not None:
        fold_probes(probes, bounds, degree)
    return out


def contact_masked_plain(
    xyzr, ids, alive, bounds, mask, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None,
    pred: Optional[torch.Tensor] = None, out=None, width=None,
    grouping: Optional[Grouping] = None, probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain masked substep: returns ``(force, degree, mask)``, the mask
    being the given tensor with the new keep set written into it and force
    and degree written into ``out`` when given; ``pred`` as in the module
    docstring; ``width`` is ``neighbors.bounds_window``'s; ``uniform_radius``,
    ``grouping`` and ``probes`` as in ``contact_seed_plain``."""
    if out is None:
        C, dev = xyzr.shape[0], xyzr.device
        out = (torch.zeros((C, 3), dtype=torch.float32, device=dev),
               torch.zeros((C,), dtype=torch.int32, device=dev))
    if _skipped(pred):
        return (*out, mask)
    pos, valid, j = _window(bounds, width)
    force, degree, keep = _substep(xyzr, ids, alive, pos, valid, _unpack(mask, j, valid),
                                   _law(radius, adhesion_const, poisson, youngs, break_d,
                                        uniform_radius), plain_lanes(bounds, pos, grouping))
    mask.copy_(_pack(keep, j, mask.shape[0]))
    out[0].copy_(force)
    out[1].copy_(degree)
    if probes is not None:
        fold_probes(probes, bounds, degree)
    return (*out, mask)


def mask_compact_plain(ids, bounds, mask, bond_cap: int,
                       pred: Optional[torch.Tensor] = None, out=None) -> torch.Tensor:
    """Plain compaction: (C, bond_cap) int32 partner ids, the first
    ``bond_cap`` set bits in candidate order, ``NO_BOND`` padded; written
    into ``out`` when given; ``pred`` as in the module docstring."""
    if out is None:
        out = torch.full((ids.shape[0], bond_cap), jkr_ops.NO_BOND, dtype=torch.int32,
                         device=ids.device)
    if _skipped(pred):
        return out
    pos, valid, j = _window(bounds)
    compact, _ = jkr_ops._compact_bonds(ids[pos], _unpack(mask, j, valid), bond_cap)
    return out.copy_(compact)


def _check_rows(xyzr, ids, alive, bounds):
    C = xyzr.shape[0]
    kernels.check_cuda("xyzr", xyzr, torch.float32, (C, 4))
    kernels.check_cuda("ids", ids, torch.int32, (C,))
    kernels.check_cuda("alive", alive, torch.bool, (C,))
    n_runs = kernels.run_count(bounds)
    kernels.check_cuda("bounds", bounds, torch.int32, (C, 2 * n_runs))
    return C, n_runs


def _check_mask(mask, C):
    if mask.dim() != 2 or mask.shape[0] < 1:
        raise ValueError(f"mask: expected (W >= 1, {C}) words, got {tuple(mask.shape)}")
    kernels.check_cuda("mask", mask, torch.int32, (mask.shape[0], C))
    return mask.shape[0]


def _pred_ptr(pred: Optional[torch.Tensor]):
    """The kernel's predicate pointer (null: always run)."""
    if pred is None:
        return None
    kernels.check_cuda("pred", pred, torch.int32, (1,))
    return pred.data_ptr()


def _outputs(out, C, device, W=None, with_mask=False):
    """The substep's force and degree buffers (and the seed's mask): the
    given ones, checked, or new ones (a mask of ``W`` words)."""
    if out is not None:
        kernels.check_cuda("force", out[0], torch.float32, (C, 3))
        kernels.check_cuda("degree", out[1], torch.int32, (C,))
        if with_mask:
            _check_mask(out[2], C)
        return out
    force = torch.empty((C, 3), dtype=torch.float32, device=device)
    degree = torch.empty((C,), dtype=torch.int32, device=device)
    if W is None:
        return force, degree
    return force, degree, torch.empty((W, C), dtype=torch.int32, device=device)


def contact_seed_cuda(
    xyzr, ids, alive, bounds, partners, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None,
    pred: Optional[torch.Tensor] = None, out=None, width=None,
    grouping: Optional[Grouping] = None, probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The seed substep. A CPU tensor runs the plain version (``width`` is
    the plain version's); a CUDA tensor launches the kernel (or raises). Without ``out`` the mask gets
    ``mask_words(bounds)`` words (a host read). ``probes`` as in
    ``ops.contact.contact_substep_cuda``, untouched where ``pred`` skips."""
    kw = dict(radius=radius, adhesion_const=adhesion_const, poisson=poisson,
              youngs=youngs, break_d=break_d, uniform_radius=uniform_radius,
              pred=pred, out=out, grouping=grouping)
    if xyzr.device.type == "cpu":
        return contact_seed_plain(xyzr, ids, alive, bounds, partners, **kw, width=width,
                                  probes=probes)
    C, n_runs = _check_rows(xyzr, ids, alive, bounds)
    K = partners.shape[1] if partners.dim() == 2 else 0
    kernels.check_cuda("partners", partners, torch.int32, (C, K))
    if K < 1:
        raise ValueError("contact_seed_cuda: bond capacity must be >= 1")
    force, degree, mask = (_outputs(out, C, xyzr.device, with_mask=True) if out is not None
                           else _outputs(None, C, xyzr.device, W=mask_words(bounds)))
    kernels.launch(
        "hipsc_contact_seed",
        xyzr.data_ptr(), ids.data_ptr(), alive.data_ptr(), bounds.data_ptr(),
        partners.data_ptr(), mask.data_ptr(), force.data_ptr(), degree.data_ptr(),
        C, K, mask.shape[0], n_runs, *pair_law_args(radius, adhesion_const, poisson,
                                                    youngs, break_d, uniform_radius),
        xla_f32.rsqrt_table(xyzr.device).data_ptr(), _pred_ptr(pred),
        *grouping_args(bounds, grouping), check_probes(probes),
    )
    kernels.count_launch(kernels.counted_name("contact_seed", n_runs))
    return force, degree, mask


def contact_masked_cuda(
    xyzr, ids, alive, bounds, mask, *, radius, adhesion_const, poisson,
    youngs, break_d, uniform_radius: Optional[float] = None,
    pred: Optional[torch.Tensor] = None, out=None, width=None,
    grouping: Optional[Grouping] = None, probes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked substep; the mask is updated in place and returned. A CPU
    tensor runs the plain version (``width`` is the plain version's); a CUDA
    tensor launches the kernel (or raises). ``probes`` as in
    ``contact_seed_cuda``."""
    kw = dict(radius=radius, adhesion_const=adhesion_const, poisson=poisson,
              youngs=youngs, break_d=break_d, uniform_radius=uniform_radius,
              pred=pred, out=out, grouping=grouping)
    if xyzr.device.type == "cpu":
        return contact_masked_plain(xyzr, ids, alive, bounds, mask, **kw, width=width,
                                    probes=probes)
    C, n_runs = _check_rows(xyzr, ids, alive, bounds)
    W = _check_mask(mask, C)
    force, degree = _outputs(out, C, xyzr.device)
    kernels.launch(
        "hipsc_contact_masked",
        xyzr.data_ptr(), alive.data_ptr(), bounds.data_ptr(),
        mask.data_ptr(), force.data_ptr(), degree.data_ptr(), C, W, n_runs,
        *pair_law_args(radius, adhesion_const, poisson, youngs, break_d,
                       uniform_radius),
        xla_f32.rsqrt_table(xyzr.device).data_ptr(), _pred_ptr(pred),
        *grouping_args(bounds, grouping), check_probes(probes),
    )
    kernels.count_launch(kernels.counted_name("contact_masked", n_runs))
    return force, degree, mask


def mask_compact_cuda(ids, bounds, mask, bond_cap: int,
                      pred: Optional[torch.Tensor] = None, out=None) -> torch.Tensor:
    """The compaction, for a bond capacity up to the engine's largest
    (``engine.MAX_BOND_CAP``). A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    from hipsc_abm_tpu_torch.engine import MAX_BOND_CAP  # the engine imports this module

    if not 1 <= bond_cap <= MAX_BOND_CAP:
        raise ValueError(f"mask_compact_cuda: bond capacity {bond_cap} outside "
                         f"1..{MAX_BOND_CAP}")
    if ids.device.type == "cpu":
        return mask_compact_plain(ids, bounds, mask, bond_cap, pred=pred, out=out)
    C = ids.shape[0]
    kernels.check_cuda("ids", ids, torch.int32, (C,))
    n_runs = kernels.run_count(bounds)
    kernels.check_cuda("bounds", bounds, torch.int32, (C, 2 * n_runs))
    W = _check_mask(mask, C)
    if out is None:
        out = torch.empty((C, bond_cap), dtype=torch.int32, device=ids.device)
    kernels.check_cuda("out", out, torch.int32, (C, bond_cap))
    kernels.launch("hipsc_mask_compact", ids.data_ptr(), bounds.data_ptr(),
                   mask.data_ptr(), out.data_ptr(), C, int(bond_cap), W, n_runs,
                   _pred_ptr(pred))
    kernels.count_launch(kernels.counted_name("mask_compact", n_runs))
    return out
