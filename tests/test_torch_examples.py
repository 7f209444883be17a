"""PyTorch port: the examples (``hipsc_abm_tpu_torch/examples``) and
``utils.profiling.device_trace`` on the CPU, against the JAX package's
examples where ``tests/test_examples.py`` runs them, on the same templates
and seeds.

- ``minimal_abm``: its draws come from the host numpy generator and its
  neighbour counts are integers, so its last values CSV equals the JAX
  example's byte for byte, and its positions are equal. (The example moves
  its locations in place; the JAX framework's values writer holds a
  reference to them, so the JAX example's earlier CSVs may already hold the
  next step's positions. The port's writer takes a copy.)
- ``chemotaxis``: the jitter is ``ops.rng.random_normal``, bit-equal to
  ``jax.random.normal`` (``split`` is bit-exact too), and the
  FTCS subcycles and the deposit round like the JAX ops only to float32
  rounding, so positions drift apart by ulps per step: after 3 steps the
  positions are held within 1e-3 um and the food eaten and the field within
  1e-5 (the field's largest value is ~40). XLA:CPU flushes subnormal floats
  to zero and PyTorch's CPU does not; far from the source the diffused
  field is subnormal, where a zero gradient (no move) and a tiny one (a
  unit step of 4 um) part, so the port runs this test with subnormals
  flushed (``torch.set_flush_denormal``, restored after it).
- ``spheroid_3d``: the port's 3D engine against the JAX one over 3 steps of
  the JAX test's ball: the integer statistics equal, the float ones within
  1e-3 um (the port-vs-JAX position gap of ``test_torch_3d.py``).
- ``run``: mode 0 of ``CellSimulation.start`` through the example's entry
  point, on small templates, into the output directory it is given.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from hipsc_abm_tpu_torch.examples import chemotaxis, minimal_abm, run, spheroid_3d
from hipsc_abm_tpu_torch.utils.profiling import device_trace

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load_jax(module_name, filename):
    spec = importlib.util.spec_from_file_location(module_name, os.path.join(EXAMPLES, filename))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _templates(root, n=40, steps=2, box=300):
    """``test_examples.py``'s templates under ``root``; returns the outputs
    directory."""
    tdir = root / "templates"
    tdir.mkdir(parents=True)
    (tdir / "general.yaml").write_text(yaml.dump({
        "num_to_start": n, "cuda": False, "end_step": steps,
        "size": [box, box, 0], "output_values": True, "output_images": False,
        "record_initial_step": False, "image_quality": 100,
        "video_quality": 80, "fps": 5, "seed": 0,
    }))
    (tdir / "experimental.yaml").write_text(yaml.dump({
        "num_gata6": 4, "output_tda": False, "output_gradients": False,
        "group": 0, "dox_step": 1, "guye_move": False, "lonely_thresh": 2,
        "color_mode": True,
    }))
    out = root / "outputs"
    out.mkdir()
    return out


def _start(cls, root, monkeypatch, name, steps, **kw):
    root.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(root)
    out = _templates(root, steps=steps)
    sim = cls.start(str(out) + os.sep, argv=["-n", name, "-m", "0"], **kw)
    return sim, out / name / f"{name}_values"


def test_minimal_abm_values_equal_the_jax_example(tmp_path, monkeypatch):
    jax_mod = _load_jax("example_minimal_abm_jax", "minimal_abm.py")
    want, want_dir = _start(jax_mod.RandomWalkers, tmp_path / "jax", monkeypatch, "rw", 2)
    got, got_dir = _start(minimal_abm.RandomWalkers, tmp_path / "port", monkeypatch, "rw", 2,
                          device="cpu")
    assert got.number_agents == 40 and got.stuck.shape == (40,)
    name = "rw_values_2.csv"
    assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes()
    np.testing.assert_array_equal(got.locations, want.locations)
    np.testing.assert_array_equal(got.stuck, want.stuck)


class RecordingWalkers(minimal_abm.RandomWalkers):
    """The walkers, keeping a copy of the positions each values CSV is
    asked for."""

    seen: dict = {}

    def step_values(self, arrays=None):
        RecordingWalkers.seen[self.current_step] = self.locations.copy()
        return super().step_values(arrays)


def test_values_csv_is_the_step_it_names(tmp_path, monkeypatch):
    """The values CSV of step 1 holds step 1's positions, though the model
    moves its locations in place during step 2."""
    seen = RecordingWalkers.seen
    seen.clear()
    _, vals = _start(RecordingWalkers, tmp_path, monkeypatch, "rw", 2, device="cpu")
    rows = np.loadtxt(vals / "rw_values_1.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(rows[:, :3], seen[1])
    assert not np.array_equal(seen[1], seen[2])


@pytest.fixture
def flushed_subnormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_chemotaxis_matches_the_jax_example(tmp_path, monkeypatch, flushed_subnormals):
    jax_mod = _load_jax("example_chemotaxis_jax", "chemotaxis.py")
    want, _ = _start(jax_mod.Chemotaxis, tmp_path / "jax", monkeypatch, "fg", 3)
    got, vals = _start(chemotaxis.Chemotaxis, tmp_path / "port", monkeypatch, "fg", 3,
                       device="cpu")
    assert got.number_agents == 40
    field = got.attractant.numpy()
    assert field.max() > 0.0 and np.isfinite(field).all()
    assert float(got.food.sum()) > 0.0
    assert (got.locations >= 0.0).all() and (got.locations[:, :2] <= 300.0).all()
    header = (vals / "fg_values_3.csv").read_text().splitlines()[0]
    assert "food" in header
    np.testing.assert_allclose(got.locations, want.locations, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.food, want.food, rtol=0, atol=1e-5)
    np.testing.assert_allclose(field, np.asarray(want.attractant), rtol=0, atol=1e-5)


def test_chemotaxis_step_is_a_function_of_its_inputs():
    """The same inputs give the same outputs, the key advances as
    ``rng.split`` says, and the inputs are left as they were."""
    from hipsc_abm_tpu_torch.ops import rng

    field = torch.zeros((31, 31))
    locs = torch.from_numpy(np.random.default_rng(3).random((20, 3)).astype(np.float32)
                            * np.float32([300, 300, 0]))
    box = torch.tensor([300.0, 300.0, 0.0])
    key = rng.prng_key(7)
    a = chemotaxis.chemotaxis_step(field, locs, key, box, 31, 31)
    b = chemotaxis.chemotaxis_step(field, locs, key, box, 31, 31)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a[3], rng.split(key)[0])
    assert float(field.abs().sum()) == 0.0


def test_spheroid_3d_matches_the_jax_example(tmp_path):
    jax_mod = _load_jax("example_spheroid_3d_jax", "spheroid_3d.py")
    _, _, want = jax_mod.run(n_cells=220, n_gata6=36, steps=3, out_dir=None, seed=0)
    out = tmp_path / "out3d"
    eng, state, stats = spheroid_3d.run(n_cells=220, n_gata6=36, steps=3, out_dir=str(out),
                                        seed=0, device="cpu")
    assert eng.cfg.two_d is False
    assert stats["population"] == want["population"] >= 220
    assert stats["differentiated"] == want["differentiated"]
    for k in ("mean_radius_um", "z_extent_um"):
        assert abs(stats[k] - want[k]) <= 1e-3, (k, stats[k], want[k])
    assert 0.0 < stats["z_extent_um"] < spheroid_3d.BOX / 2.0
    locs = state.arrays["locations"].numpy()[state.alive.numpy()]
    assert (locs >= 0.0).all() and (locs <= spheroid_3d.BOX).all()
    assert (out / "spheroid_xy.png").is_file()
    assert (out / "spheroid_xz.png").is_file()


def test_run_entry_point_mode_0(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = _templates(tmp_path, n=60, steps=2)
    sim = run.main(["-n", "r0", "-m", "0", "-d", "cpu"], output_dir=str(out))
    assert sim.device.type == "cpu" and sim.current_step == 2
    assert (out / "r0" / "r0_values" / "r0_values_2.csv").is_file()
    assert run.OUTPUTS.endswith(os.path.join("hipsc_abm_tpu_torch", "examples", "outputs"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host "
                    "without CUDA")
def test_examples_need_cuda_by_default(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA"):
        spheroid_3d.run(n_cells=20, n_gata6=2, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        _start(chemotaxis.Chemotaxis, tmp_path, monkeypatch, "fg", 1)


def test_device_trace_writes_a_trace_and_none_does_nothing(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)):
        torch.arange(1000.0).cumsum(0)
    traces = list(log_dir.glob("trace_*.json"))
    assert len(traces) == 1
    assert '"traceEvents"' in traces[0].read_text()
    with device_trace(None):
        torch.ones(3).sum()
    assert list(log_dir.iterdir()) == traces
