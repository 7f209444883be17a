"""The contact kernels (and the bio-moments kernel) of two checkouts on the
same state, bit for bit.

    python hipsc_abm_tpu_torch/tools/contact_ab.py dump ROOT OUT.npz [--dims 2|3] [--path id_list|span_mask|bio]
    python hipsc_abm_tpu_torch/tools/contact_ab.py compare A.npz B.npz

``dump`` imports ``hipsc_abm_tpu_torch`` and ``chip_smoke`` from the
checkout at ROOT, builds the main path's state there (``chip_smoke``'s 3D
99k spheroid or 2D 100k bench colony after ``init_state(seed=0)`` and one
``safe_step``, on the card), and runs the contact kernels of one path on the
physics scan's first substep inputs:

- ``id_list`` (the default): ``contact_substep_cuda`` (B6) once; saves
  inputs, forces, degrees and partner lists;
- ``span_mask``: the seed (B2), then the masked substep (B1) at the
  positions the seed's forces move the rows to, with the seed's mask, then
  the compaction (B3) of the masked substep's mask, as ``chip_smoke``'s
  kernel phase runs them; saves inputs, the moved positions, both substeps'
  forces, degrees and mask words, and the compacted partner ids;
- ``bio``: the neighbour moments (B4) on the step's real inputs. One more
  ``step`` runs with the engine's three bio-moments calls recorded (count
  after the build, pathway after division and death, motility after the
  fate phases, so deaths and births since the build are present); each
  call is replayed in its own mode and the motility call's inputs in all
  four modes. Saves the step's input state, the run bounds and every
  output.

It also times each kernel of the path alone (bio: in each mode), per launch
under ``torch.profiler`` (``hipsc_abm_tpu_torch.tools.kernel_ms``, 20
launches after the run whose outputs are saved), and saves the times with
the card's name. The profiler helper and the recording of the engine's
calls are the checkout's own, so ROOT must hold them.
Run it from two checkouts (for example a change and its parent, unpacked
with ``git archive``), then ``compare``: the inputs must be equal (the
earlier steps ran the same kernels) and every output is compared element
for element, forces and moments by their float32 bits; the times of both
are printed side by side.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

# the kernels of each path as the profiler names them, by output prefix
KERNELS = {
    "id_list": {"": "contact_substep_kernel"},
    "span_mask": {"seed_": "contact_mask_kernel<true", "": "contact_mask_kernel<false",
                  "compact_": "mask_compact_kernel"},
}
TIMED_LAUNCHES = 20
BIO_MODES = ("count", "pathway", "motility", "full")
BIO_KERNEL = "bio_moments_kernel"
# the outputs of a bio dump: each engine call in its own mode, then the
# motility call's inputs in every mode
BIO_OUTPUTS = ("count_call", "pathway_call") + tuple(f"motility_call_{m}" for m in BIO_MODES)
BIO_INPUTS = ("in_ids", "in_loc", "in_alive", "in_bounds")


def bio_outputs(eng, state) -> tuple:
    """The ``bio`` dump's arrays (``BIO_INPUTS`` and ``BIO_OUTPUTS``, as
    tensors) for one ``step`` of ``eng`` from ``state``, and the recorded
    calls."""
    from hipsc_abm_tpu_torch.ops import bio_moments
    from hipsc_abm_tpu_torch.tools import record_bio_calls

    saved = dict(in_ids=state.arrays["ids"], in_loc=state.arrays["locations"],
                 in_alive=state.alive)
    calls = record_bio_calls(eng, state)
    fn = bio_moments.bio_moments_cuda
    (a1, k1), (a2, k2), (a3, k3) = calls
    saved.update(in_bounds=a1[2], count_call=fn(*a1, **k1), pathway_call=fn(*a2, **k2))
    for mode in BIO_MODES:
        saved[f"motility_call_{mode}"] = fn(*a3, **{**k3, "mode": mode})
    return saved, calls


def _dump_bio(eng, state) -> tuple:
    """The ``bio`` path of ``dump``: ``(outputs, each mode's kernel alone,
    ms per launch)``."""
    from hipsc_abm_tpu_torch.ops import bio_moments
    from hipsc_abm_tpu_torch.tools import kernel_ms

    saved, calls = bio_outputs(eng, state)
    fn = bio_moments.bio_moments_cuda
    a3, k3 = calls[2]
    times = {f"bio_{mode}_ms": kernel_ms(lambda: fn(*a3, **{**k3, "mode": mode}), BIO_KERNEL,
                                         TIMED_LAUNCHES)
             for mode in BIO_MODES}
    return saved, times


def dump(root: str, out: str, dims: int, path: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from hipsc_abm_tpu_torch.ops import contact, span_mask
    from hipsc_abm_tpu_torch.ops import neighbors as nbr
    from hipsc_abm_tpu_torch.ops.integrate import stokes_integrate
    from hipsc_abm_tpu_torch.ops.jkr import pack_physics
    from hipsc_abm_tpu_torch.tools import kernel_ms

    if not torch.cuda.is_available():
        raise SystemExit("contact_ab dump: no CUDA device")
    n = chip_smoke.N_MAIN_3D if dims == 3 else chip_smoke.N_MAIN
    eng, state = chip_smoke.engine_for(dims, n, "cuda", "id_list")
    state, _ = eng.safe_step(state)
    if path == "bio":
        saved, times = _dump_bio(eng, state)
        torch.cuda.synchronize()
        _save(out, path, {k: v.cpu().numpy() for k, v in saved.items()}, times)
        print(f"contact_ab dump: {root} {dims}D bio rows={saved['in_bounds'].shape[0]} -> "
              f"{out}; {BIO_KERNEL} alone per launch (profiler, {TIMED_LAUNCHES} launches): "
              + ", ".join(f"{m} {times[f'bio_{m}_ms']:.5f} ms" for m in BIO_MODES)
              + f" [{_card()}]")
        return
    cfg, bio, a, alive = eng.cfg, eng.bio, state.arrays, state.alive
    grid = nbr.build_grid(cfg.jkr_spec, a["locations"], a["ids"], alive)
    o = grid.order
    args = (pack_physics(a["locations"][o], a["radii"][o]), a["ids"][o].contiguous(),
            alive[o].contiguous(), nbr.run_bounds(cfg.jkr_spec, grid.sorted_flat),
            state.bonds.ids()[o].contiguous())
    law = dict(radius=bio.jkr_radius, adhesion_const=bio.adhesion_const,
               poisson=bio.poisson, youngs=bio.youngs, break_d=bio.jkr_break_d,
               uniform_radius=cfg.uniform_radius)
    saved = {f"in{i}": t for i, t in enumerate(args)}
    K = args[4].shape[1]
    if path == "id_list":
        runs = {"": lambda: contact.contact_substep_cuda(*args, **law)}
        saved["force"], saved["degree"], saved["partners"] = runs[""]()
    else:
        f1, d1, m1 = span_mask.contact_seed_cuda(*args, **law)
        saved.update(seed_force=f1, seed_degree=d1, seed_mask=m1.clone())
        size = torch.tensor(eng.gen.size, dtype=torch.float32, device=f1.device)
        loc1 = stokes_integrate(args[0][:, :3], args[0][:, 3], f1, torch.zeros_like(f1),
                                args[2], bio.stokes, size, float(bio.move_dt))
        moved = (pack_physics(loc1, args[0][:, 3]), *args[1:4])
        saved["moved"] = moved[0]
        saved["force"], saved["degree"], mask = span_mask.contact_masked_cuda(
            *moved, m1, **law)
        saved["mask"] = mask.clone()
        saved["compact"] = span_mask.mask_compact_cuda(args[1], args[3], mask, K)
        # the masked substep at fixed positions reaches its fixed point in
        # one launch, so repeated launches time the same work
        runs = {"seed_": lambda: span_mask.contact_seed_cuda(*args, **law),
                "": lambda: span_mask.contact_masked_cuda(*moved, mask, **law),
                "compact_": lambda: span_mask.mask_compact_cuda(args[1], args[3], mask, K)}
    torch.cuda.synchronize()
    arrays = {k: v.cpu().numpy() for k, v in saved.items()}
    times = {}
    for prefix, fn in runs.items():
        times[f"{prefix}ms"] = kernel_ms(fn, KERNELS[path][prefix], TIMED_LAUNCHES)
    _save(out, path, arrays, times)
    timed = ", ".join(f"{KERNELS[path][k[:-2]]} {v:.5f} ms" for k, v in times.items())
    print(f"contact_ab dump: {root} {dims}D {path} rows={args[0].shape[0]} K={K} "
          f"-> {out}; kernel alone per launch (profiler, {TIMED_LAUNCHES} launches): "
          f"{timed} [{_card()}]")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def _save(out: str, path: str, arrays: dict, times: dict) -> None:
    np.savez(out, path=np.array(path), card=np.array(_card()), **arrays,
             **{k: np.float64(v) for k, v in times.items()})


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


def compare(a_path: str, b_path: str) -> bool:
    a, b = np.load(a_path), np.load(b_path)
    path = str(a["path"]) if "path" in a.files else "id_list"
    if path != (str(b["path"]) if "path" in b.files else "id_list"):
        print("contact_ab compare: the dumps are of different contact paths")
        return False
    if path == "bio":
        inputs, outputs = BIO_INPUTS, BIO_OUTPUTS
    else:
        inputs = [f"in{i}" for i in range(5)] + (["moved"] if path == "span_mask" else [])
        outputs = (["force", "degree", "partners"] if path == "id_list" else
                   ["seed_force", "seed_degree", "seed_mask", "force", "degree", "mask",
                    "compact"])
    ok_in = all(a[k].shape == b[k].shape and np.array_equal(_bits(a[k]), _bits(b[k]))
                for k in inputs)
    report, ok = [], ok_in
    for k in outputs:
        same = a[k].shape == b[k].shape and np.array_equal(_bits(a[k]), _bits(b[k]))
        ok &= same
        note = ""
        if not same and a[k].shape == b[k].shape:
            if a[k].dtype == np.float32:
                note = f" (max |d| {float(np.abs(a[k] - b[k]).max()):.3e})"
            else:  # rows differ: (C,) and (C, K) by row, (W, C) mask words by column
                diff = a[k] != b[k]
                n = int((diff.any(axis=0) if k.endswith("mask") else
                         diff.any(axis=1) if diff.ndim == 2 else diff).sum())
                note = f" ({n} rows differ)"
        report.append(f"{k} {'equal' if same else 'DIFFER'}{note}")
    print(f"contact_ab compare [{path}]: inputs equal {ok_in}; {', '.join(report)}")
    if path == "bio":
        timed = [(f"bio_{m}_ms", f"{BIO_KERNEL}[{m}] alone per launch, ms") for m in BIO_MODES]
    else:
        timed = [(f"{prefix}ms", f"{name} alone per launch, ms")
                 for prefix, name in KERNELS[path].items()]
    for key, label in timed:
        if key in a.files and key in b.files:
            print(f"  {label}: A {float(a[key]):.5f}, B {float(b[key]):.5f}")
    return bool(ok)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("root")
    d.add_argument("out")
    d.add_argument("--dims", type=int, choices=(2, 3), default=3)
    d.add_argument("--path", choices=tuple(KERNELS) + ("bio",), default="id_list")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "dump":
        dump(args.root, args.out, args.dims, args.path)
        return 0
    return 0 if compare(args.a, args.b) else 1


if __name__ == "__main__":
    sys.exit(main())
