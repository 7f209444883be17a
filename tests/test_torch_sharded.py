"""PyTorch port: the domain engine's sharded checkpoints and value shards
(``DomainHipscEngine.save_checkpoint_sharded`` / ``load_checkpoint_sharded``
/ ``write_values_sharded``, ``utils.checkpoint.save_domain_sharded`` /
``load_domain_sharded``, ``utils.io.merge_sharded_values``) on the CPU.

- A resume on the same tile grid places every tile's slot block back as it
  was saved: bit-exact, the lattice included. An elastic resume onto
  another grid re-partitions: agents bit-exact by id, the lattice within
  1e-5 (the deposit's float sums follow slot order, which a re-partition
  changes).
- The format is the JAX package's: a port shard set loads in JAX's
  ``load_domain_sharded`` (every leaf equal) and resumes in JAX's
  ``DomainHipscEngine`` (8-device CPU mesh of ``tests/conftest.py``), and a
  JAX shard set resumes in the port, each then stepped beside the other
  package, the port on the general pair law: integers and bond sets equal
  by id, positions within ``XLA_SPACINGS`` float32 spacings of the largest
  coordinate (measured 1 after one step, 2 after two) and lattices within
  1e-5. The JAX domain engine runs its XLA path, whose pair law takes a
  square root and divides by it where the TPU kernels, which the port
  follows, multiply by ``rsqrt``, and which sums each row's padded window
  in 32-wide partial sums (``test_torch_domain.py``).
- At step 0 the port's value shards are byte-equal to JAX's (the same
  partition and slot order), and their merge equals the flat
  ``write_values_csv`` of the colony.
- ``merge_sharded_values`` raises on a missing interior or trailing shard.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from hipsc_abm_tpu.models.params import DiffusionParams as JaxDiffusionParams
from hipsc_abm_tpu.models.params import ExperimentalParams as JaxExperimentalParams
from hipsc_abm_tpu.models.params import GeneralParams as JaxGeneralParams
from hipsc_abm_tpu.parallel.domain_engine import DomainHipscEngine as JaxDomainEngine
from hipsc_abm_tpu.utils import checkpoint as jax_ckpt
from hipsc_abm_tpu_torch import colonies, convert
from hipsc_abm_tpu_torch.parallel import DomainHipscEngine
from hipsc_abm_tpu_torch.utils import checkpoint as ckpt
from hipsc_abm_tpu_torch.utils import io as io_utils

torch.set_num_threads(1)

DIFF = dict(spat_res=25.0, diffuse_dt=6.0, diffuse_const=2.0, max_concentration=2.0,
            degradation=0.05, release_amount=0.02, uptake_amount=0.004)
N, GATA6, BOX = 700, 70, 1400.0
needs_mesh = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device CPU mesh")


def jax_params():
    return (JaxGeneralParams(num_to_start=N, end_step=8, size=(BOX, BOX, 0.0)),
            JaxExperimentalParams(num_gata6=GATA6, dox_step=1), JaxDiffusionParams(**DIFF))


def port_engine(**grid):
    """The port's domain engine on the general pair law, the law of the JAX
    domain engine's XLA path, which some checks step beside it."""
    gen, xp, diff = (convert.params_from_jax(p) for p in jax_params())
    dom = DomainHipscEngine(gen, xp, diff=diff, enable_diffusion=True, device="cpu",
                            **(grid or {"tiles": (2, 2)}))
    dom.cfg = dataclasses.replace(dom.cfg, base=dataclasses.replace(dom.cfg.base,
                                                                    uniform_radius=None))
    return dom


def jax_engine():
    gen, xp, diff = jax_params()
    return JaxDomainEngine(gen, xp, diff=diff, tiles=(2, 2), use_pallas=False,
                           enable_diffusion=True)


def port_flat(dom, dstate) -> dict:
    return convert.state_to_numpy(dom.to_cell_state(dstate))


def assert_bits(a: dict, b: dict, lattice_atol=None):
    colonies.assert_same(a, b, "shards", lattice_atol=lattice_atol)


# positions against the JAX XLA path, in float32 spacings of the largest
# coordinate (module docstring)
XLA_SPACINGS = 4


def assert_close_to_jax(port: dict, jax_state: dict):
    a, b = colonies.by_id(jax_state), colonies.by_id(port)
    for k in ("ids", "FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states", "death_counters",
              "diff_counters", "div_counters", "fds_counters"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert colonies.bond_rows_apart(b["bonds"], a["bonds"]) == 0
    spacing = float(np.spacing(np.abs(a["locations"]).max().astype(np.float32)))
    np.testing.assert_allclose(b["locations"], a["locations"], rtol=0,
                               atol=XLA_SPACINGS * spacing)
    np.testing.assert_allclose(port["gradients"]["fgf4_values"],
                               jax_state["gradients"]["fgf4_values"], rtol=0, atol=1e-5)


def test_sharded_resume_bit_exact_on_the_same_grid_and_elastic_on_others(tmp_path):
    dom = port_engine()
    state = dom.init_state(seed=11)
    for _ in range(2):
        state, _ = dom.safe_step(state)
    path = str(tmp_path / "ck")
    dom.save_checkpoint_sharded(path, state)
    saved_cfg = dom.cfg
    assert sorted(os.listdir(path)) == ["manifest.json"] + [f"shard_{s}.npz" for s in range(4)]
    for _ in range(2):
        state, _ = dom.safe_step(state)
    want = port_flat(dom, state)

    same = port_engine()
    restored = same.load_checkpoint_sharded(path)
    assert same.cfg == dataclasses.replace(saved_cfg, base=dataclasses.replace(
        saved_cfg.base, mask_bits=0))  # the mask width is derived again
    for _ in range(2):
        restored, _ = same.safe_step(restored)
    assert_bits(port_flat(same, restored), want)  # the lattice bit for bit too

    for grid in ({"n_stripes": 2}, {"tiles": (1, 4)}):
        other = port_engine(**grid)
        with pytest.raises(ValueError, match="elastic"):
            other.load_checkpoint_sharded(path)
        resumed = other.load_checkpoint_sharded(path, elastic=True)
        for _ in range(2):
            resumed, _ = other.safe_step(resumed)
        assert_bits(port_flat(other, resumed), want, lattice_atol=1e-5)


@needs_mesh
def test_shard_sets_cross_between_the_packages(tmp_path):
    dom = port_engine()
    state = dom.init_state(seed=11)
    for _ in range(2):  # bonds and a lattice to carry over
        state, _ = dom.safe_step(state)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    dom.save_checkpoint_sharded(port_dir, state)

    # the JAX package reads the port's shards, leaf for leaf ...
    jflat, jmeta = jax_ckpt.load_domain_sharded(port_dir)
    mine = port_flat(dom, state)
    theirs = convert.numpy_from_jax_state(jflat)
    for k, v in mine["arrays"].items():
        np.testing.assert_array_equal(theirs["arrays"][k], v, err_msg=k)
    for k in ("alive", "partners", "bond_mask", "key", "step", "next_id"):
        np.testing.assert_array_equal(theirs[k], mine[k], err_msg=k)
    np.testing.assert_array_equal(theirs["gradients"]["fgf4_values"],
                                  mine["gradients"]["fgf4_values"])
    assert jmeta["n_shards"] == 4

    # ... and resumes them in its domain engine, beside the port
    jdom = jax_engine()
    js = jdom.load_checkpoint_sharded(port_dir)
    js, _ = jdom.safe_step(js)
    state, _ = dom.safe_step(state)
    assert_close_to_jax(port_flat(dom, state),
                        convert.numpy_from_jax_state(jdom.to_cell_state(js)))

    # a JAX shard set resumes in the port exactly as JAX holds it
    jdom.save_checkpoint_sharded(jax_dir, js)
    back = port_engine()
    bs = back.load_checkpoint_sharded(jax_dir)
    assert_bits(port_flat(back, bs), convert.numpy_from_jax_state(jdom.to_cell_state(js)))
    bs, _ = back.safe_step(bs)
    js, _ = jdom.safe_step(js)
    assert_close_to_jax(port_flat(back, bs),
                        convert.numpy_from_jax_state(jdom.to_cell_state(js)))


def test_value_shards_equal_jax_at_step_0_and_merge_to_the_flat_csv(tmp_path, monkeypatch):
    # the JAX package's native CSV writer aborts on some row counts
    # (ROADMAP C1): its Python writer, byte-equal, writes the reference
    monkeypatch.setenv("HIPSC_NO_NATIVE_IO", "1")
    dom = port_engine()
    state = dom.init_state(seed=11)
    mine = dom.write_values_sharded(str(tmp_path / "port"), "v", 0, state)
    jdom = jax_engine()
    theirs = jdom.write_values_sharded(str(tmp_path / "jax"), "v", 0, jdom.init_state(seed=11))
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs] == [
        f"v_values_0.shard{s}.csv" for s in range(4)]
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a

    merged = io_utils.merge_sharded_values(str(tmp_path / "port"), "v", 0, n_shards=4)
    flat = port_flat(dom, state)
    alive = flat["alive"]
    order = sorted(flat["arrays"])
    io_utils.write_values_csv(str(tmp_path / "flat.csv"),
                              {k: flat["arrays"][k][alive] for k in order}, order)
    with open(merged, "rb") as fm, open(tmp_path / "flat.csv", "rb") as ff:
        merged_bytes = fm.read()
        assert merged_bytes == ff.read()
    assert merged_bytes.count(b"\n") == 1 + int(alive.sum())


def test_merge_raises_on_a_missing_interior_or_trailing_shard(tmp_path):
    dom = port_engine()
    state = dom.init_state(seed=3)
    paths = dom.write_values_sharded(str(tmp_path), "v", 1, state)
    os.remove(paths[1])
    with pytest.raises(FileNotFoundError, match="incomplete"):
        io_utils.merge_sharded_values(str(tmp_path), "v", 1)
    dom.write_values_sharded(str(tmp_path), "v", 1, state)
    os.remove(paths[3])
    io_utils.merge_sharded_values(str(tmp_path), "v", 1)  # a trailing gap shows only with
    with pytest.raises(FileNotFoundError, match="incomplete"):  # the tile count
        io_utils.merge_sharded_values(str(tmp_path), "v", 1, n_shards=4)
    with pytest.raises(FileNotFoundError, match="no v_values_2"):
        io_utils.merge_sharded_values(str(tmp_path), "v", 2)


def test_shard_zero_carries_the_replicated_leaves_in_the_jax_dtypes(tmp_path):
    dom = port_engine()
    state, _ = dom.safe_step(dom.init_state(seed=5))
    dom.save_checkpoint_sharded(str(tmp_path), state)
    with np.load(tmp_path / "shard_0.npz") as s0, np.load(tmp_path / "shard_1.npz") as s1:
        assert s0["key"].dtype == np.uint32 and s0["key"].shape == (2,)
        assert s0["step"].dtype == np.int32 and s0["next_id"].dtype == np.int32
        assert "gradients/fgf4_values" in s0.files
        assert not any(k.startswith("gradients/") or k in ("key", "step", "next_id")
                       for k in s1.files)
        assert s1["alive"].shape == (dom.cfg.per_stripe,)
    blocks, shared, meta = ckpt.load_domain_tiles(str(tmp_path), [2])
    assert sorted(blocks) == [2] and meta["format_version"] == 2
    assert int(shared["step"]) == state.step
