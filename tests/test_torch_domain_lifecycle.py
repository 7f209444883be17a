"""PyTorch port: the model lifecycle on the domain-decomposed engine
(``domain_tiles`` in ``general.yaml``), on the CPU: 700 cells in a
1,500 um box, the colony of ``tests/test_domain_lifecycle.py``.

- mode 0 writes the single-engine run's files, and a mode-1 continuation
  from the pickle equals the uninterrupted run bit for bit by agent id;
- the colony equals the single-engine lifecycle's;
- the npz resumes without the pickle; a scalar ``domain_tiles`` means
  x-stripes; an npz resumes on another tile grid or on one engine
  (elastic mode 1); ``output_interval`` blocks give the same colony;
- a JAX domain checkpoint resumes in the port and a port one in the JAX
  package: one step on from the same state, integers and bond sets equal
  by id, positions within 16 float32 spacings of the largest coordinate
  (see ``test_torch_domain.py``).
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from hipsc_abm_tpu.models.hipsc import CellSimulation as JaxCellSimulation
from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.models.hipsc import CellSimulation
from hipsc_abm_tpu_torch.parallel import DomainHipscEngine

GENERAL = {
    "num_to_start": 700, "cuda": False, "end_step": 4, "size": [1500, 1500, 0],
    "output_values": True, "output_images": False, "record_initial_step": True,
    "image_quality": 100, "video_quality": 80, "fps": 5, "seed": 0,
    "domain_tiles": [2, 2],
}
EXPERIMENTAL = {
    "num_gata6": 70, "output_tda": True, "output_gradients": False, "group": 0,
    "dox_step": 1, "guye_move": True, "lonely_thresh": 2, "color_mode": True,
}
INT_FIELDS = ("FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters")
requires_mesh = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device CPU mesh")


# one thread: the small ops of a tile step are slower on a thread pool that
# other test workers share (as in test_torch_calibrate.py)
torch.set_num_threads(1)


def _env(root, **general) -> str:
    (root / "templates").mkdir(parents=True, exist_ok=True)
    gen = {**GENERAL, **general}
    (root / "templates" / "general.yaml").write_text(
        yaml.dump({k: v for k, v in gen.items() if v is not None}))
    (root / "templates" / "experimental.yaml").write_text(yaml.dump(EXPERIMENTAL))
    (root / "outputs").mkdir(exist_ok=True)
    return str(root / "outputs") + os.sep


def _start(root, out, argv, cls=CellSimulation, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("HIPSC_NO_NATIVE_IO", "1")
        if cls is CellSimulation:
            kwargs.setdefault("device", "cpu")
        return cls.start(out, argv=argv, **kwargs)


def _flat(sim) -> dict:
    """The flat host state of a port or JAX simulation."""
    if isinstance(sim, JaxCellSimulation):
        state = sim.engine.to_cell_state(sim.state) if sim._is_domain else sim.state
        return convert.numpy_from_jax_state(state)
    return sim._flat_host()


def _by_id(d: dict) -> dict:
    alive = d["alive"]
    order = np.argsort(d["arrays"]["ids"][alive])
    out = {k: v[alive][order] for k, v in d["arrays"].items()}
    partners = np.where(d["bond_mask"], d["partners"], -1)[alive][order]
    out["bonds"] = [frozenset(r[r >= 0].tolist()) for r in partners]
    return out


def _assert_same_colony(got: dict, ref: dict, exact: bool = True) -> None:
    a, b = _by_id(got), _by_id(ref)
    np.testing.assert_array_equal(a["ids"], b["ids"])
    for k in INT_FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["bonds"] == b["bonds"]
    if exact:
        for k in a:
            if k != "bonds":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        spacing = float(np.spacing(np.abs(b["locations"]).max().astype(np.float32)))
        np.testing.assert_allclose(a["locations"], b["locations"], rtol=0, atol=16 * spacing)


@pytest.fixture(scope="module")
def domain_run(tmp_path_factory):
    """The uninterrupted mode-0 run on 2 x 2 tiles to step 4."""
    root = tmp_path_factory.mktemp("domain")
    out = _env(root, output_images=True)
    sim = _start(root, out, ["-n", "d", "-m", "0"])
    return dict(root=root, out=out, sim=sim, state=_flat(sim))


@pytest.fixture(scope="module")
def step2(tmp_path_factory):
    """A 2 x 2 tile run to step 2 with ``temp_pickle: false``: its output
    directory (the npz checkpoint) to resume from."""
    root = tmp_path_factory.mktemp("step2")
    out = _env(root, end_step=2, temp_pickle=False)
    _start(root, out, ["-n", "s", "-m", "0"])
    return os.path.join(out, "s")


def _resume_npz(tmp_path, step2_dir, fs, **general):
    out = _env(tmp_path, temp_pickle=False, **general)
    shutil.copytree(step2_dir, os.path.join(out, "s"))
    return _start(tmp_path, out, ["-n", "s", "-m", "1", "-fs", str(fs)])


def test_domain_lifecycle_outputs_and_continuation(domain_run, tmp_path):
    sim = domain_run["sim"]
    assert isinstance(sim.engine, DomainHipscEngine)
    assert (sim.engine.cfg.n_tx, sim.engine.cfg.n_ty) == (2, 2)
    assert sim.current_step == 4 and sim.number_agents > 700
    run = os.path.join(domain_run["out"], "d")
    for sub in ("d_values", "d_images", "d_tda/all"):
        assert len(os.listdir(os.path.join(run, sub))) >= 4, sub
    for f in ("d_data.csv", "d_state.npz", "d_temp.pkl"):
        assert os.path.exists(os.path.join(run, f)), f
    # mode 0 to step 2, then mode 1 from the pickle to step 4
    out = _env(tmp_path, end_step=2)
    _start(tmp_path, out, ["-n", "c", "-m", "0"])
    resumed = _start(tmp_path, out, ["-n", "c", "-m", "1", "-fs", "4"])
    assert isinstance(resumed.engine, DomainHipscEngine)
    _assert_same_colony(_flat(resumed), domain_run["state"])


def test_domain_lifecycle_matches_single_engine(domain_run, tmp_path):
    out = _env(tmp_path, domain_tiles=None)
    sim = _start(tmp_path, out, ["-n", "one", "-m", "0"])
    assert not isinstance(sim.engine, DomainHipscEngine)
    _assert_same_colony(_flat(sim), domain_run["state"])


def test_domain_npz_resume_without_pickle(domain_run, step2, tmp_path):
    sim = _resume_npz(tmp_path, step2, 4)
    assert (sim.engine.cfg.n_tx, sim.engine.cfg.n_ty) == (2, 2)
    _assert_same_colony(_flat(sim), domain_run["state"])


def test_scalar_domain_tiles_means_stripes(domain_run, tmp_path):
    out = _env(tmp_path, domain_tiles=3, output_values=False)
    sim = _start(tmp_path, out, ["-n", "x", "-m", "0"])
    assert (sim.engine.cfg.n_tx, sim.engine.cfg.n_ty) == (3, 1)
    _assert_same_colony(_flat(sim), domain_run["state"])


@pytest.mark.parametrize("tiles", [[4, 1], None], ids=["stripes4", "single"])
def test_elastic_mode1_resume(domain_run, step2, tmp_path, tiles):
    sim = _resume_npz(tmp_path, step2, 4, domain_tiles=tiles)
    assert isinstance(sim.engine, DomainHipscEngine) == (tiles is not None)
    if tiles is not None:
        assert (sim.engine.cfg.n_tx, sim.engine.cfg.n_ty) == tuple(tiles)
    _assert_same_colony(_flat(sim), domain_run["state"])


def test_domain_output_interval_blocks(domain_run, tmp_path):
    out = _env(tmp_path, output_interval=2)
    sim = _start(tmp_path, out, ["-n", "b", "-m", "0"])
    assert sim.current_step == 4
    _assert_same_colony(_flat(sim), domain_run["state"])


@requires_mesh
def test_jax_domain_checkpoint_resumes_in_port(tmp_path):
    out = _env(tmp_path, end_step=2, temp_pickle=False)
    _start(tmp_path, out, ["-n", "j", "-m", "0"], cls=JaxCellSimulation)
    shutil.copytree(os.path.join(out, "j"), tmp_path / "j2")
    jsim = _start(tmp_path, out, ["-n", "j", "-m", "1", "-fs", "3"], cls=JaxCellSimulation)
    shutil.rmtree(os.path.join(out, "j"))
    shutil.copytree(tmp_path / "j2", os.path.join(out, "j"))
    tsim = _start(tmp_path, out, ["-n", "j", "-m", "1", "-fs", "3"])
    assert isinstance(tsim.engine, DomainHipscEngine) and tsim.current_step == 3
    assert tsim.engine.cfg.per_stripe == jsim.engine.cfg.per_stripe
    _assert_same_colony(_flat(tsim), _flat(jsim), exact=False)


@requires_mesh
def test_port_domain_checkpoint_resumes_in_jax(domain_run, step2, tmp_path):
    out = _env(tmp_path, temp_pickle=False)
    shutil.copytree(step2, os.path.join(out, "s"))
    jsim = _start(tmp_path, out, ["-n", "s", "-m", "1", "-fs", "3"], cls=JaxCellSimulation)
    assert jsim._is_domain and jsim.current_step == 3
    shutil.rmtree(os.path.join(out, "s"))
    shutil.copytree(step2, os.path.join(out, "s"))
    tsim = _start(tmp_path, out, ["-n", "s", "-m", "1", "-fs", "3"])
    _assert_same_colony(_flat(jsim), _flat(tsim), exact=False)
