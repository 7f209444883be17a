"""PyTorch port: the model lifecycle (``CellSimulation.start``, modes 0-3) on
the CPU, against itself and against the JAX package's ``CellSimulation``.

- modes 0-3 write the files the JAX lifecycle writes;
- a mode-1 resume, from the pickle and from the npz, is bit-exact against
  the uninterrupted run;
- the port's mode-0 run equals the JAX model's at 80 cells over 4 steps:
  the same engine config, and by agent id integer fields and bond sets
  exact, positions within 1e-3 um (float32 force sums taken in another
  order, see ``test_torch_step.py``);
- a JAX npz checkpoint resumes in the port and matches JAX continuing the
  same run, also with the three optional biology phases on; a port npz
  loads in the JAX package;
- the optional phases (``enable_growth``, ``enable_stochastic``,
  ``enable_diff_surround``) run through the lifecycle: the engine's config
  carries each flag, a pickle resume with all three is bit-exact, and grown
  radii reach the step images and the npz;
- ``domain_tiles`` (ROADMAP A10) no longer raises ``NotImplementedError``.

The JAX side writes its CSVs with its Python writers
(``HIPSC_NO_NATIVE_IO=1``).
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from hipsc_abm_tpu.engine import config_to_meta as jax_config_to_meta
from hipsc_abm_tpu.models.hipsc import CellSimulation as JaxCellSimulation
from hipsc_abm_tpu.utils import checkpoint as jckpt
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import config_to_meta
from hipsc_abm_tpu_torch.models.hipsc import CellSimulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERAL = {
    "num_to_start": 80, "cuda": False, "end_step": 4, "size": [200, 200, 0],
    "output_values": True, "output_images": True, "record_initial_step": True,
    "image_quality": 100, "video_quality": 80, "fps": 5, "seed": 0,
}
EXPERIMENTAL = {
    "num_gata6": 8, "output_tda": True, "output_gradients": False, "group": 0,
    "dox_step": 1, "guye_move": True, "lonely_thresh": 2, "color_mode": True,
}
OPTIONAL = {"enable_growth": True, "enable_stochastic": True, "enable_diff_surround": True}
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")


def _env(root, general=None, experimental=None) -> str:
    """Templates under ``root`` and an empty output directory; returns it."""
    (root / "templates").mkdir(parents=True)
    (root / "templates" / "general.yaml").write_text(yaml.dump({**GENERAL, **(general or {})}))
    (root / "templates" / "experimental.yaml").write_text(
        yaml.dump({**EXPERIMENTAL, **(experimental or {})}))
    (root / "outputs").mkdir()
    return str(root / "outputs") + os.sep


def _start(root, out, argv, cls=CellSimulation, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("HIPSC_NO_NATIVE_IO", "1")  # the JAX package's Python writers
        return cls.start(out, argv=argv, **kwargs)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's uninterrupted mode-0 run to step 4, every output on."""
    root = tmp_path_factory.mktemp("port")
    out = _env(root)
    sim = _start(root, out, ["-n", "full", "-m", "0"], device="cpu")
    return dict(root=root, out=out, sim=sim, state=convert.state_to_numpy(sim.state))


def _jax_resumed_run(root, experimental=None) -> dict:
    """One JAX run with ``temp_pickle: false``: mode 0 to step 2 (its output
    directory copied aside), then mode 1 to step 4."""
    out = _env(root, general={"temp_pickle": False, "end_step": 2}, experimental=experimental)
    _start(root, out, ["-n", "j", "-m", "0"], cls=JaxCellSimulation)
    shutil.copytree(os.path.join(out, "j"), root / "step2" / "j")
    sim = _start(root, out, ["-n", "j", "-m", "1", "-fs", "4"], cls=JaxCellSimulation)
    return dict(step2=root / "step2" / "j", state=convert.numpy_from_jax_state(sim.state),
                meta=jax_config_to_meta(sim.engine.cfg))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_resumed_run(tmp_path_factory.mktemp("jax"))


def _by_id(d: dict) -> dict:
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [frozenset(r[r >= 0].tolist()) for r in partners]
    return out


def _assert_same_colony(got: dict, ref: dict, atol: float) -> None:
    a, b = _by_id(got), _by_id(ref)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in INT_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["bonds"] == b["bonds"]
    if atol == 0:
        np.testing.assert_array_equal(a["locations"], b["locations"])
    else:
        np.testing.assert_allclose(a["locations"], b["locations"], rtol=0, atol=atol)


def _assert_bit_equal(got: dict, ref: dict) -> None:
    for k in ref["arrays"]:
        np.testing.assert_array_equal(got["arrays"][k], ref["arrays"][k], err_msg=k)
    for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_modes_0_to_3_and_pickle_resume(tmp_path, port_run):
    out = _env(tmp_path, general={"end_step": 2})
    sim = _start(tmp_path, out, ["-n", "lc", "-m", "0"], device="cpu")
    base = os.path.join(out, "lc")
    assert sim.number_agents > 0
    for step in (0, 1, 2):
        assert os.path.isfile(os.path.join(base, "lc_values", f"lc_values_{step}.csv"))
        assert os.path.isfile(os.path.join(base, "lc_images", f"lc_image_{step}.png"))
    for group in ("red", "green", "all"):
        assert os.path.isfile(os.path.join(base, "lc_tda", group, f"lc_tda_{group}_2.csv"))
    for name in ("lc_temp.pkl", "lc_state.npz", "lc_data.csv", "lc_video.mp4"):
        assert os.path.isfile(os.path.join(base, name)), name
    with open(os.path.join(base, "lc_values", "lc_values_2.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[:3] == ["locations[0]", "locations[1]", "locations[2]"]
    assert "GATA6" in header and "div_counters" in header

    # the pickle holds host numpy and no engine
    with open(os.path.join(base, "lc_temp.pkl"), "rb") as f:
        pickled = pickle.load(f)
    assert pickled.engine is None and pickled.state is None
    host, cfg_meta = pickled._resume
    assert isinstance(host["alive"], np.ndarray) and cfg_meta["capacity"] > 0

    sim2 = _start(tmp_path, out, ["-n", "lc", "-m", "1", "-fs", "4"], device="cpu")
    assert sim2.current_step == 4
    assert os.path.isfile(os.path.join(base, "lc_values", "lc_values_4.csv"))
    _assert_bit_equal(convert.state_to_numpy(sim2.state), port_run["state"])

    os.remove(os.path.join(base, "lc_video.mp4"))
    _start(tmp_path, out, ["-n", "lc", "-m", "2"], device="cpu")
    assert os.path.isfile(os.path.join(base, "lc_video.mp4"))
    _start(tmp_path, out, ["-n", "lc", "-m", "3"], device="cpu")
    assert os.path.isfile(os.path.join(out, "lc.zip"))


def test_npz_resume_is_bit_exact(tmp_path, port_run):
    out = _env(tmp_path, general={"end_step": 2, "temp_pickle": False})
    _start(tmp_path, out, ["-n", "np", "-m", "0"], device="cpu")
    base = os.path.join(out, "np")
    assert not os.path.isfile(os.path.join(base, "np_temp.pkl"))
    assert os.path.isfile(os.path.join(base, "np_state.npz"))
    sim = _start(tmp_path, out, ["-n", "np", "-m", "1", "-fs", "4"], device="cpu")
    _assert_bit_equal(convert.state_to_numpy(sim.state), port_run["state"])


def test_mode0_matches_jax(port_run, jax_run):
    tmeta = config_to_meta(port_run["sim"].engine.cfg)
    jmeta = jax_run["meta"]
    for k, v in tmeta.items():
        if k in ("nbr_spec", "jkr_spec"):  # the JAX window width run_cap aside
            v = {f: x for f, x in v.items() if f != "run_cap"}
            assert {f: x for f, x in jmeta[k].items() if f != "run_cap"} == v, k
        elif k not in ("contact_path", "mask_bits"):  # the port's own
            assert jmeta[k] == v, k
    _assert_same_colony(port_run["state"], jax_run["state"], atol=1e-3)
    assert port_run["sim"].number_agents == int(jax_run["state"]["alive"].sum())


def test_jax_npz_resumes_in_port(tmp_path, jax_run):
    out = _env(tmp_path, general={"temp_pickle": False})
    shutil.copytree(jax_run["step2"], os.path.join(out, "j"))
    sim = _start(tmp_path, out, ["-n", "j", "-m", "1", "-fs", "4"], device="cpu")
    assert sim.current_step == 4
    _assert_same_colony(convert.state_to_numpy(sim.state), jax_run["state"], atol=1e-3)


def test_jax_npz_with_optional_phases_resumes_in_port(tmp_path):
    """A JAX checkpoint written with the three optional phases on resumes in
    the port (its config keeps the flags) and matches JAX continuing the
    run."""
    ref = _jax_resumed_run(tmp_path / "jax", experimental=OPTIONAL)
    assert all(ref["meta"][k] for k in OPTIONAL) and ref["meta"]["uniform_radius"] is None
    root = tmp_path / "port"
    out = _env(root, general={"temp_pickle": False}, experimental=OPTIONAL)
    shutil.copytree(ref["step2"], os.path.join(out, "j"))
    sim = _start(root, out, ["-n", "j", "-m", "1", "-fs", "4"], device="cpu")
    cfg = sim.engine.cfg
    assert sim.current_step == 4 and all(getattr(cfg, k) for k in OPTIONAL)
    assert cfg.uniform_radius is None
    _assert_same_colony(convert.state_to_numpy(sim.state), ref["state"], atol=1e-3)


def test_port_npz_loads_in_jax(port_run):
    path = os.path.join(port_run["out"], "full", "full_state.npz")
    state, meta = jckpt.load_state(path)
    assert meta["current_step"] == 4 and meta["format_version"] == 2
    assert meta["engine_config"] == config_to_meta(port_run["sim"].engine.cfg)
    _assert_bit_equal(convert.numpy_from_jax_state(state), port_run["state"])


@pytest.mark.parametrize("general,experimental,item", [
    ({"domain_tiles": [2, 2]}, {}, "A10"),
])
def test_unported_options_raise(tmp_path, general, experimental, item):
    """ROADMAP ``item`` is ported now (``test_torch_domain_lifecycle.py``
    checks it in full): the option no longer raises ``NotImplementedError``,
    and the run ends on the domain engine."""
    from hipsc_abm_tpu_torch.parallel import DomainHipscEngine

    out = _env(tmp_path, general={**general, "output_images": False},
               experimental=experimental)
    sim = _start(tmp_path, out, ["-n", "x", "-m", "0"], device="cpu")
    assert isinstance(sim.engine, DomainHipscEngine) and item == "A10"
    assert sim.current_step == GENERAL["end_step"] and sim.number_agents > 0


@pytest.mark.parametrize("flags", [("enable_growth",), ("enable_stochastic",),
                                   ("enable_diff_surround",), tuple(OPTIONAL)],
                         ids=["growth", "stochastic", "diff_surround", "all"])
def test_optional_phases_run(tmp_path, flags):
    """Mode 0 for 2 steps on the CPU with each optional phase, and with all
    three: the engine's config carries the flags, and growth selects the
    contact kernels' general pair law."""
    out = _env(tmp_path, general={"end_step": 2, "output_images": False},
               experimental={k: True for k in flags})
    sim = _start(tmp_path, out, ["-n", "opt", "-m", "0"], device="cpu")
    cfg = sim.engine.cfg
    assert sim.current_step == 2 and sim.number_agents > 0
    for k in OPTIONAL:
        assert getattr(cfg, k) == (k in flags), k
    assert (cfg.uniform_radius is None) == ("enable_growth" in flags)
    assert config_to_meta(cfg)["enable_stochastic"] == ("enable_stochastic" in flags)


def test_optional_phases_pickle_resume_is_bit_exact(tmp_path):
    """With the three phases on: mode 0 to step 2, then mode 1 from the
    pickle to step 4, bit-equal to mode 0 straight to step 4."""
    out = _env(tmp_path, general={"end_step": 2, "output_images": False},
               experimental=OPTIONAL)
    _start(tmp_path, out, ["-n", "a", "-m", "0"], device="cpu")
    resumed = _start(tmp_path, out, ["-n", "a", "-m", "1", "-fs", "4"], device="cpu")
    assert all(getattr(resumed.engine.cfg, k) for k in OPTIONAL)
    root = tmp_path / "straight"
    out = _env(root, general={"end_step": 4, "output_images": False}, experimental=OPTIONAL)
    straight = _start(root, out, ["-n", "b", "-m", "0"], device="cpu")
    _assert_bit_equal(convert.state_to_numpy(resumed.state),
                      convert.state_to_numpy(straight.state))


class SeededRadiiSimulation(CellSimulation):
    """The model with radii drawn uniform in [min_radius, max_radius] at
    set-up (every radius is max_radius otherwise, and growth then has
    nothing to do)."""

    def agent_initials(self):
        super().agent_initials()
        rs = np.random.default_rng(3)
        self.radii = rs.uniform(self.min_radius, self.max_radius,
                                self.number_agents).astype(np.float32)


def test_grown_radii_reach_the_outputs(tmp_path, monkeypatch):
    """Growth on, radii seeded: the step images are rendered with each
    step's grown radii (the values CSV holds the reference's nine arrays,
    radii not among them), and the npz checkpoint holds them."""
    from hipsc_abm_tpu_torch.utils import io as io_utils
    from hipsc_abm_tpu_torch.utils.checkpoint import load_state

    rendered = []
    render = io_utils.render_step_image
    monkeypatch.setattr(io_utils, "render_step_image", lambda locs, radii, *a, **k: (
        rendered.append(np.array(radii)), render(locs, radii, *a, **k))[1])
    out = _env(tmp_path, general={"end_step": 2}, experimental={"enable_growth": True})
    sim = _start(tmp_path, out, ["-n", "g", "-m", "0"], cls=SeededRadiiSimulation,
                 device="cpu")
    assert sim.engine.cfg.uniform_radius is None and len(rendered) == 3
    np.testing.assert_array_equal(rendered[-1], sim.radii)
    assert sim.radii.min() < sim.max_radius and not np.array_equal(rendered[0], rendered[-1])
    state, _ = load_state(os.path.join(out, "g", "g_state.npz"), device="cpu")
    np.testing.assert_array_equal(state.arrays["radii"][state.alive].numpy(), sim.radii)


def test_cli_entry_point(tmp_path):
    """``python -m hipsc_abm_tpu_torch`` with ``paths.yaml`` in the working
    directory, on the CPU."""
    _env(tmp_path, general={"end_step": 1, "output_images": False})
    (tmp_path / "paths.yaml").write_text("output_dir: ./outputs\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", "hipsc_abm_tpu_torch", "-n", "cli", "-m",
                           "0", "-d", "cpu"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Step: 1" in proc.stdout
    assert os.path.isfile(tmp_path / "outputs" / "cli" / "cli_values" / "cli_values_1.csv")
