"""PyTorch port: the window probes P1 and P2 (``hipsc_abm_tpu_torch.tools``,
the plain versions of ``csrc/dynslice_probe.cu``; the kernels themselves are
held to them in test_torch_cuda.py) vs the JAX package's Mosaic probes
``tools/dynslice_probe.py`` and ``tools/dynslice_probe2.py``, their
``pallas_call`` built as their ``run`` builds it but in interpret mode, at
NBLK = 4 with the probes' own seeds.

``tools/`` is no package and its probes set a JAX compilation cache at
import, so they are loaded from their files and the cache setting is put
back afterwards.

The edge cases of the port's kernels (window offsets at the span's ends)
are held here too, through the same ``make_inputs(offset=...)`` the card
tests use, and the kernels' grid (``launch_shape``) is checked without a
card.

Tolerances, from measured error: P1 sums 128 terms ``dx * d2`` of |.| < 2
in another order (rtol 1e-5, atol 1e-5 for sums that cancel to near 0); P2
sums up to 512 terms of |.| < 25 with ``torch.rsqrt`` against XLA's rsqrt
(rtol 1e-4, atol 1e-4 x the largest |output|).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hipsc_abm_tpu_torch import kernels
from hipsc_abm_tpu_torch.tools import dynslice_probe as tp1
from hipsc_abm_tpu_torch.tools import dynslice_probe2 as tp2
from hipsc_abm_tpu_torch.tools import parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBLK = 4


def _load(name):
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture(scope="module")
def jp1():
    return _load("dynslice_probe")


@pytest.fixture(scope="module")
def jp2():
    return _load("dynslice_probe2")


def _jax_probe(mod, mode, offs, rows, span, rows_per_block, span_lanes):
    """The probe's ``pallas_call`` as its ``run`` builds it, at NBLK
    programs, in interpret mode."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(NBLK,),
        in_specs=[pl.BlockSpec((rows_per_block, 8), lambda i, *s: (i, 0)),
                  pl.BlockSpec((8, span_lanes), lambda i, *s: (0, i))],
        out_specs=pl.BlockSpec((rows_per_block, 1), lambda i, *s: (i, 0)),
    )
    out = pl.pallas_call(
        functools.partial(mod.kernel, mode=mode), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((NBLK * rows_per_block, 1), jnp.float32),
        interpret=True,
    )(*(jnp.asarray(t.numpy()) for t in (offs, rows, span)))
    return np.asarray(out)


@pytest.mark.parametrize("mode", tp1.MODES)
def test_probe1_plain_matches_pallas_interpret(jp1, mode):
    inputs = tp1.make_inputs(NBLK, "cpu")
    want = _jax_probe(jp1, mode, *inputs, jp1.G * jp1.ROWS, jp1.SPAN)
    before = kernels.launch_counts["dynslice_probe"]
    got = tp1.probe_cuda(*inputs, mode)
    assert kernels.launch_counts["dynslice_probe"] == before  # CPU: plain version
    assert got.shape == want.shape == (NBLK * 128, 1)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", tp2.MODES)
def test_probe2_plain_matches_pallas_interpret(jp2, mode):
    inputs = tp2.make_inputs(NBLK, "cpu")
    want = _jax_probe(jp2, mode, *inputs, jp2.B, jp2.SPAN)
    before = kernels.launch_counts["dynslice_probe2"]
    got = tp2.probe_cuda(*inputs, mode)
    assert kernels.launch_counts["dynslice_probe2"] == before
    assert got.shape == want.shape == (NBLK * 128, 1)
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("offset", [0, 1, 895, 896])
def test_probe1_plain_matches_pallas_interpret_at_edge_offsets(jp1, offset):
    """dyn_unaligned windows at the span block's first lanes and at its
    last window (SPAN - W = 896)."""
    inputs = tp1.make_inputs(NBLK, "cpu", offset=offset)
    assert int(inputs[0].min()) == int(inputs[0].max()) == offset
    want = _jax_probe(jp1, "dyn_unaligned", *inputs, jp1.G * jp1.ROWS, jp1.SPAN)
    got = tp1.probe_cuda(*inputs, "dyn_unaligned")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 383, 511])
@pytest.mark.parametrize("mode", ["quarters", "octets"])
def test_probe2_plain_matches_pallas_interpret_at_edge_offsets(jp2, mode, offset):
    """128-lane windows from offsets whose aligned start is 0, 256 and 384
    (511 // 128 * 128 = 384 = SPAN - W, the clamp both probes apply)."""
    inputs = tp2.make_inputs(NBLK, "cpu", offset=offset)
    want = _jax_probe(jp2, mode, *inputs, jp2.B, jp2.SPAN)
    got = tp2.probe_cuda(*inputs, mode)
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


def _programs_per_sm(nblk, n_sm, shape):
    """Programs each SM walks under ``shape``, with blocks dealt to the SMs
    in turn (all resident at once) and warp w of the grid walking programs
    w, w + warps, ..., as the kernels do."""
    blocks, threads, _ = shape
    warps = blocks * (threads // 32)
    per_sm = [0] * n_sm
    for w in range(min(warps, nblk)):
        per_sm[(w // (threads // 32)) % n_sm] += len(range(w, nblk, warps))
    return per_sm


@pytest.mark.parametrize("nblk,n_sm,warps_per_sm,want,most", [
    (4096, 132, 32, (1024, 128, 1), 32), (1, 132, 32, (1, 128, 1), 1),
    (3, 132, 32, (1, 128, 1), 3), (133, 132, 32, (34, 128, 1), 4),
    (2117, 132, 32, (530, 128, 1), 20), (4096, 132, 8, (264, 128, 2), 32),
    (2117, 132, 8, (264, 128, 2), 20), (4096, 114, 8, (228, 128, 2), 36),
    (0, 132, 8, (1, 128, 1), 0)])
def test_probe_launch_shape(nblk, n_sm, warps_per_sm, want, most):
    """The probes' grid: at most ``warps_per_sm`` warps per SM, so the grid
    is resident at once; every program walked once; a second buffer
    whenever a warp walks more than one program; at the probes' 4096
    programs no SM walks more than ceil(4096 / n_sm) (32 on an H100's 132
    SMs), at P1's and P2's settings alike."""
    assert (tp1.WARPS_PER_SM, tp2.WARPS_PER_SM) == (32, 8)
    shape = tp1.launch_shape(nblk, n_sm, warps_per_sm)
    assert shape == want
    blocks, threads, buffers = shape
    warps = blocks * threads // 32
    assert threads == 32 * tp1.WARPS_PER_BLOCK
    assert -(-blocks // n_sm) * tp1.WARPS_PER_BLOCK <= warps_per_sm
    assert (buffers == 2) == (warps < nblk)
    per_sm = _programs_per_sm(nblk, n_sm, shape)
    assert sum(per_sm) == nblk and max(per_sm) == most


def test_probe_constants_match_the_jax_probes(jp1, jp2):
    """Modes, shapes, seeds' draws and repetitions are the JAX probes'."""
    for name in ("NBLK", "SPAN", "G", "ROWS", "W", "REPS"):
        assert getattr(tp1, name) == getattr(jp1, name), name
    for name in ("NBLK", "SPAN", "B", "REPS"):
        assert getattr(tp2, name) == getattr(jp2, name), name
    # the modes each probe's command line runs by default
    assert parse_args([], tp1.MODES, "").modes == ["static", "dyn_aligned", "dyn_unaligned"]
    assert parse_args([], tp2.MODES, "").modes == ["full", "half", "q256", "quarters",
                                                   "octets"]
    assert parse_args([], tp1.MODES, "").device == "cuda"
    args = parse_args(["--device", "cpu", "octets"], tp2.MODES, "")
    assert (args.device, args.modes) == ("cpu", ["octets"])
    for argv in (["bogus"], ["--nblk", "8"]):
        with pytest.raises(SystemExit):
            parse_args(argv, tp1.MODES, "")
    # the windows of P2 (group rows, lanes) as the JAX kernel tabulates them
    for mode, (group, width) in tp2.GROUPS.items():
        assert tp2.lanes(mode, 1) == {"full": jp2.B * jp2.SPAN, "quarters": jp2.B * 128,
                                      "q256": jp2.B * 256, "octets": jp2.B * 128,
                                      "half": jp2.B * 256}[mode]
        assert jp2.B % group == 0
    assert tp1.lanes(1) == jp1.G * jp1.ROWS * jp1.W


def _small(monkeypatch, probe, nblk):
    """The probe's ``main`` with each mode run at ``nblk`` programs and one
    timed call instead of the JAX probe's NBLK and REPS."""
    full = probe.run
    monkeypatch.setattr(probe, "run", lambda mode, device: full(mode, device, nblk, 1))


def test_probe_cli_runs_on_the_cpu(monkeypatch, capsys):
    _small(monkeypatch, tp1, 2)
    _small(monkeypatch, tp2, 2)
    out1 = tp1.main(["--device", "cpu", "dyn_unaligned"])
    out2 = tp2.main(["--device", "cpu"])
    assert [r["mode"] for r in out1] == ["dyn_unaligned"]
    assert [r["mode"] for r in out2] == list(tp2.MODES)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all("Glanes/s" in line for line in lines)
    assert all(r["ms"] > 0 for r in out1 + out2)


def test_probe_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _small(monkeypatch, tp1, 1)
    with pytest.raises((RuntimeError, AssertionError)):
        tp1.main(["static"])
