"""CellSimulation: the hiPSC colony model on the port's engine (port of
``hipsc_abm_tpu/models/hipsc.py``).

It reads ``experimental.yaml``, exposes the biology constants as
attributes, seeds the initial colony through the framework's registration
API with the same numpy draws as the JAX model, and runs each step as one
``HipscEngine.safe_step`` on ``self.device``, followed by the outputs: step
images in both color modes, value CSVs, TDA splits, gradient CSVs, the pickle
and npz checkpoints, the data CSV and the end-of-run video.

With ``output_interval: k`` > 1 (``general.yaml``) the steps between
outputs run as blocks of ``HipscEngine.run_steps`` (on the card one CUDA
graph replay and one probe fetch per block), as in the JAX model: the
per-step prints come from the block's stacked probes, and the outputs and
checkpoints land on block boundaries only.

The template keys ``enable_growth``, ``enable_stochastic`` and
``enable_diff_surround`` (``experimental.yaml``) turn on the phases the
reference ships disabled. ``domain_tiles: [n_tx, n_ty]`` (or a scalar for
x-stripes, ``general.yaml``) runs the whole lifecycle on the
domain-decomposed engine (``parallel.domain_engine``), its tiles on the
cards in turn (all on one card when there is one): the outputs and
checkpoints are those of a single-engine run, and a checkpoint resumes on
another tile grid, or on the single engine, bit-exact (elastic mode 1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from hipsc_abm_tpu_torch import convert
from hipsc_abm_tpu_torch.engine import (
    HIPSC_ARRAY_SPECS, CellState, HipscEngine, config_from_meta, config_to_meta)
from hipsc_abm_tpu_torch.ops import rng
from hipsc_abm_tpu_torch.parallel.domain_engine import (
    DomainHipscEngine, domain_config_from_meta, domain_config_to_meta)
from hipsc_abm_tpu_torch.params import BiologyParams, DiffusionParams, ExperimentalParams
from hipsc_abm_tpu_torch.simulation import Simulation
from hipsc_abm_tpu_torch.utils import io as io_utils
from hipsc_abm_tpu_torch.utils.checkpoint import load_state, save_state
from hipsc_abm_tpu_torch.utils.config import check_direct, template_params
from hipsc_abm_tpu_torch.utils.profiling import record_block, record_time

OUTPUT_ARRAYS = [
    "locations", "FGF4", "FGFR", "ERK", "GATA6", "NANOG", "states",
    "diff_counters", "div_counters",
]  # the nine arrays the reference writes to the values CSV each step


class CellSimulation(Simulation):
    """hiPSC colony simulation (NANOG/GATA6 fate, JKR contact mechanics)."""

    def __init__(self, name: str, output_path: str, device="cuda"):
        super().__init__(name, output_path, device=device)

        keys = template_params(self.templates_path + "experimental.yaml")
        self.num_gata6 = keys["num_gata6"]
        self.output_tda = keys["output_tda"]
        self.output_gradients = keys["output_gradients"]
        self.group = keys["group"]  # vestigial in the reference; kept for parity
        self.dox_step = keys["dox_step"]
        self.guye_move = keys["guye_move"]
        self.lonely_thresh = keys["lonely_thresh"]
        self.color_mode = keys["color_mode"]

        self.gradients_path = self.main_path + name + "_gradients" + self.separator
        self.tda_path = self.main_path + name + "_tda" + self.separator

        # the biology constants as attributes; BiologyParams is the source
        self.biology_params = BiologyParams()
        bio = self.biology_params
        self.step_dt = bio.step_dt
        self.move_dt = bio.move_dt
        self.field = bio.field
        self.GATA6_prob = bio.GATA6_prob
        self.NANOG_prob = bio.NANOG_prob
        self.pluri_div_thresh = bio.pluri_div_thresh
        self.diff_div_thresh = bio.diff_div_thresh
        self.pluri_to_diff = bio.pluri_to_diff
        self.death_thresh = bio.death_thresh
        self.fds_thresh = bio.fds_thresh
        self.max_radius = bio.max_radius
        self.min_radius = bio.min_radius
        self.pluri_growth = bio.pluri_growth
        self.diff_growth = bio.diff_growth

        self.experimental_params = ExperimentalParams.from_dict(keys)
        self.enable_growth = bool(keys.get("enable_growth", False))
        self.enable_stochastic = bool(keys.get("enable_stochastic", False))
        self.enable_diff_surround = bool(keys.get("enable_diff_surround", False))
        self.enable_diffusion = bool(keys.get("enable_diffusion", False))
        self.diffusion_params = (
            DiffusionParams(
                spat_res=float(keys.get("spat_res", 10.0)),
                diffuse_dt=float(keys.get("diffuse_dt", 6.0)),
                diffuse_const=float(keys.get("diffuse_const", 2.0)),
                max_concentration=float(keys.get("max_concentration", 2.0)),
                degradation=float(keys.get("degradation", 0.1)),
                release_amount=float(keys.get("release_amount", 0.0)),
                uptake_amount=float(keys.get("uptake_amount", 0.0)),
                field_coupling=bool(keys.get("field_coupling", False)),
            )
            if self.enable_diffusion
            else None
        )

        self.engine: Optional[HipscEngine] = None
        self.state: Optional[CellState] = None
        self._host_state: Optional[dict] = None

    # ------------------------------------------------------------------
    # initial conditions
    # ------------------------------------------------------------------

    def agent_initials(self):
        rng_np = self._np_rng
        self.add_agents(self.num_to_start)
        self.add_agents(self.num_gata6, agent_type="GATA6_high")

        self.agent_array("locations", override=rng_np.random((self.number_agents, 3)) * self.size)
        self.agent_array("radii", func=lambda: self.max_radius)
        self.agent_array("FGF4", dtype=int, func=lambda: rng_np.integers(0, self.field))
        self.agent_array("FGFR", dtype=int, func=lambda: rng_np.integers(0, self.field))
        self.agent_array("ERK", dtype=int, func=lambda: rng_np.integers(0, self.field))
        self.agent_array("GATA6", dtype=int)
        self.agent_array("NANOG", dtype=int, func=lambda: rng_np.integers(0, self.field))
        self.agent_array("states", dtype=int)
        self.agent_array("death_counters", dtype=int,
                         func=lambda: rng_np.integers(0, self.death_thresh))
        self.agent_array("diff_counters", dtype=int,
                         func=lambda: rng_np.integers(0, self.pluri_to_diff))
        self.agent_array("div_counters", dtype=int,
                         func=lambda: rng_np.integers(0, self.pluri_div_thresh))
        self.agent_array("fds_counters", dtype=int,
                         func=(lambda: rng_np.integers(0, self.fds_thresh))
                         if self.fds_thresh > 1 else (lambda: 0))
        self.agent_array("motility_forces", vector=3)
        self.agent_array("jkr_forces", vector=3)

        self.agent_array("GATA6", agent_type="GATA6_high",
                         func=lambda: rng_np.integers(1, max(self.field, 2)))
        self.agent_array("NANOG", agent_type="GATA6_high", func=lambda: 0)

        self.agent_graph("neighbor_graph")
        self.agent_graph("jkr_graph")

    # ------------------------------------------------------------------
    # engine wiring
    # ------------------------------------------------------------------

    def _make_engine(self):
        """``HipscEngine``, or with ``domain_tiles`` the
        ``DomainHipscEngine`` of that tile grid."""
        params = (self.general_params, self.experimental_params, self.biology_params,
                  self.diffusion_params)
        flags = dict(enable_diffusion=self.enable_diffusion, enable_growth=self.enable_growth,
                     enable_stochastic=self.enable_stochastic,
                     enable_diff_surround=self.enable_diff_surround, device=self.device)
        if self._is_domain:
            return DomainHipscEngine(*params, tiles=self.domain_tiles, **flags)
        return HipscEngine(*params, **flags)

    @property
    def _is_domain(self) -> bool:
        return getattr(self, "domain_tiles", None) is not None

    def _base_cfg(self):
        """The engine's (base) EngineConfig."""
        return self.engine.cfg.base if self._is_domain else self.engine.cfg

    def _adopt_config(self, meta: dict) -> None:
        """Take a checkpoint's engine config, keeping this engine's contact
        path (a kernel choice, not dynamics)."""
        self.engine.cfg = dataclasses.replace(config_from_meta(meta),
                                              contact_path=self.engine.cfg.contact_path)

    def _adopt_domain_config(self, meta: dict) -> None:
        """Take a checkpoint's DomainConfig, keeping this engine's contact
        path."""
        cfg = domain_config_from_meta(meta)
        self.engine.cfg = dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, contact_path=self.engine.cfg.base.contact_path))

    def build_state(self) -> None:
        """Pack the registered host arrays into the engine's state on
        ``self.device``."""
        if self.engine is None:
            self.engine = self._make_engine()
        cfg = self._base_cfg()
        n = self.number_agents
        if n > cfg.capacity:
            cfg = dataclasses.replace(
                cfg, capacity=max(cfg.capacity, ((int(n * 1.5) + 127) // 128) * 128))
        # the contact kernels' scalar-radius pair law assumes equal radii;
        # custom seeded radii select the general pair law
        if cfg.uniform_radius is not None and not np.all(
                np.asarray(self.radii)[:n] == cfg.uniform_radius):
            cfg = dataclasses.replace(cfg, uniform_radius=None)
        if self._is_domain:
            # the flat state below is a staging layout that from_cell_state
            # partitions tile-major; the per-tile slots rule
            self.engine.cfg = dataclasses.replace(self.engine.cfg, base=cfg)
        else:
            self.engine.cfg = cfg
        C = cfg.capacity

        arrays = {}
        for name, (dtype, vec) in HIPSC_ARRAY_SPECS.items():
            shape = (C,) if vec is None else (C, vec)
            host = np.zeros(shape, dtype=np.int32 if dtype == torch.int32 else np.float32)
            if name == "ids":  # the engine's stable identity
                host[:n] = np.arange(n, dtype=np.int32)
            else:
                host[:n] = np.asarray(self.__dict__[name])
            arrays[name] = host
        alive = np.zeros((C,), dtype=bool)
        alive[:n] = True

        gradients: Dict[str, np.ndarray] = {}
        if cfg.enable_diffusion and self.diffusion_params is not None:
            gradients["fgf4_values"] = np.zeros(
                self.diffusion_params.grid_size(tuple(self.size)), dtype=np.float32)
            self.gradient_names = ["fgf4_values"]

        self.state = self._device_state({
            "arrays": arrays, "alive": alive,
            "partners": np.zeros((C, cfg.bond_cap), dtype=np.int32),
            "bond_mask": np.zeros((C, cfg.bond_cap), dtype=bool),
            "gradients": gradients,
            "key": rng.prng_key(self.seed).numpy().astype(np.uint32),
            "step": self.beginning_step,
            "next_id": n,
        })

    def _device_state(self, host: dict):
        """The engine's state from a flat host state: a ``CellState`` on
        ``self.device``, or the domain engine's partition of it."""
        if self._is_domain:
            return self.engine.from_cell_state(convert.state_from_numpy(host, "cpu"))
        return convert.state_from_numpy(host, self.device)

    def _ensure_state(self) -> None:
        """Build the state from the registered arrays, or put a resumed
        pickle's host state on ``self.device`` under its engine config."""
        resume = self.__dict__.pop("_resume", None)
        if resume is None:
            self.build_state()
            return
        host, cfg_meta = resume
        self.engine = self._make_engine()
        if isinstance(cfg_meta, tuple):  # ("domain", DomainConfig meta)
            self._adopt_domain_config(cfg_meta[1])
        elif cfg_meta is not None:
            self._adopt_config(cfg_meta)
        self.state = self._device_state(host)

    def _sync_host(self) -> None:
        """Copy the whole state to the host once per step and derive the
        live-agent attributes (``self.locations`` etc.) from it. The copy is
        kept for this step's checkpoint writers, so that the pickle and the
        npz do not each fetch the state again."""
        host = self._flat_host()
        self._host_state = host
        alive = host["alive"]
        for name in self.agent_array_names:
            self.__dict__[name] = host["arrays"][name][alive]
        self.number_agents = int(alive.sum())

    def _flat_host(self) -> dict:
        """The state as a flat host numpy dict (the domain engine's tiles
        flattened tile-major)."""
        state = self.engine.to_cell_state(self.state) if self._is_domain else self.state
        return convert.state_to_numpy(state)

    def _host(self) -> dict:
        return self._host_state if self._host_state is not None else self._flat_host()

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def steps(self):
        if self.state is None:
            self._ensure_state()
        if self.record_initial_step:
            self.record_initials()

        step = self.beginning_step
        while step <= self.end_step:
            self._host_state = None  # the cache belongs to the previous step
            if self.output_interval == 1:
                self.current_step = step
                self.info()
                # the fused step: neighbours, division, death, pathway,
                # differentiation, (growth/stochastic/diff_surround/diffusion),
                # motility, 11 contact substeps
                with record_block(self, "step_fused"):
                    self.state, info = self.engine.safe_step(self.state)
                print("\tAdded " + str(int(info.num_added)) + " agents")
                print("\tRemoved " + str(int(info.num_removed)) + " agents")
                step += 1
            else:
                step = self._run_block(step)

            self._sync_host()
            self.step_image()
            self.step_values(arrays=OUTPUT_ARRAYS)
            if self.enable_diffusion:
                self.step_gradients()
            self.step_tda()
            self.temp()
            self.data()

        self.create_video()  # flushes the output queue first

    def _run_block(self, step: int) -> int:
        """Steps ``step`` .. ``step + k - 1`` as one ``run_steps`` block,
        ``k = min(output_interval, end_step + 1 - step)``, with the
        reference's per-step prints from the stacked probes; returns the
        next step. The data CSV's step time is the whole block's wall with
        the boundary's outputs (``step_start`` is taken before the block)."""
        k = min(self.output_interval, self.end_step + 1 - step)
        n_before = self.number_agents
        self.step_start = time.perf_counter()
        with record_block(self, "step_fused"):
            self.state, infos = self.engine.run_steps(self.state, k)
        for j in range(k):
            self.current_step = step + j
            print("Step: " + str(self.current_step))
            print("Number of agents: "
                  + str(n_before if j == 0 else int(infos.num_agents[j - 1])))
            print("\tAdded " + str(int(infos.num_added[j])) + " agents")
            print("\tRemoved " + str(int(infos.num_removed[j])) + " agents")
        return step + k

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    @record_time
    def step_image(self, background=(0, 0, 0), origin_bottom=True):
        if self.output_images:
            check_direct(self.images_path)
            n = self.number_agents
            # the host arrays are rebound each step, never mutated in place;
            # rendering and encoding run on the background writer
            states, gata6, nanog = self.states[:n], self.GATA6[:n], self.NANOG[:n]
            locations, radii = self.locations[:n], self.radii[:n]
            field, color_mode = self.field, self.color_mode
            size, quality = tuple(self.size), self.image_quality
            path = self.images_path + f"{self.name}_image_{self.current_step}.png"

            def render_and_save():
                colors = io_utils.hipsc_cell_colors(np.asarray(states), np.asarray(gata6),
                                                    np.asarray(nanog), field, color_mode)
                image = io_utils.render_step_image(
                    np.asarray(locations), np.asarray(radii), colors, size, quality,
                    background=background, origin_bottom=origin_bottom)
                io_utils.save_image_png(path, image)

            io_utils.submit_output(render_and_save)

    @record_time
    def step_gradients(self):
        if self.output_gradients and self.state is not None:
            check_direct(self.gradients_path)
            grads = self._host()["gradients"]
            path, name, step = self.gradients_path, self.name, self.current_step
            io_utils.submit_output(lambda: io_utils.write_gradient_csvs(path, name, step, grads))

    @record_time
    def step_tda(self):
        if self.output_tda:
            check_direct(self.tda_path)
            n = self.number_agents
            locs, gata6, nanog = self.locations[:n], self.GATA6[:n], self.NANOG[:n]
            path, name, step = self.tda_path, self.name, self.current_step
            io_utils.submit_output(lambda: io_utils.write_tda_csvs(
                path, name, step, np.asarray(locs), np.asarray(gata6), np.asarray(nanog)))

    @record_time
    def temp(self):
        """Checkpoints: the pickle of the simulation (the reference's
        mechanism, with the state as host numpy), unless ``temp_pickle`` is
        false, and the npz of the state alone (``utils.checkpoint``)."""
        if self.temp_pickle:
            super().temp.__wrapped__(self)  # the pickle, not timed again
        if self.state is not None:
            state = self._host()
            path = os.path.join(self.main_path, f"{self.name}_state.npz")
            meta = {"current_step": self.current_step, "name": self.name}
            if self._is_domain:
                # both in the JAX package's layout, so that either package
                # resumes the checkpoint, on tiles or on one engine
                meta["domain_config"] = domain_config_to_meta(self.engine.cfg)
                meta["engine_config"] = meta["domain_config"]["base"]
            else:
                meta["engine_config"] = config_to_meta(self.engine.cfg)
            io_utils.submit_output(lambda: save_state(path, state, meta=meta))

    # ------------------------------------------------------------------
    # resume (mode 1)
    # ------------------------------------------------------------------

    @classmethod
    def resume_from_npz(cls, name, output_dir, device="cuda"):
        """Mode 1 without the per-step pickle (``temp_pickle: false``):
        rebuild the simulation from the templates (assumed unchanged since
        the run started) and restore the npz state and its engine config.
        Either package's checkpoint resumes here. The templates'
        ``domain_tiles`` decide the engine: the checkpoint's tile grid
        adopts its exact DomainConfig; another grid, or tiles where the
        checkpoint had one engine, re-partitions (elastic); no tiles where
        the checkpoint had them continues on one engine. All three are
        bit-exact: the dynamics do not depend on the layout."""
        sim = cls(name, output_dir, device=device)
        sim.agent_initials()  # registers the host arrays; the draws are replaced below
        state, meta = load_state(os.path.join(sim.main_path, f"{name}_state.npz"),
                                 device="cpu" if sim._is_domain else sim.device)
        ckpt_tiles = None
        if "domain_config" in meta:
            cfgd = domain_config_from_meta(meta["domain_config"])
            ckpt_tiles = (cfgd.n_tx, cfgd.n_ty)
        sim.engine = sim._make_engine()
        if sim.domain_tiles is not None and sim.domain_tiles == ckpt_tiles:
            sim._adopt_domain_config(meta["domain_config"])
            sim.state = sim.engine.from_cell_state(state)
        elif sim._is_domain:
            sim.state = sim.engine._adopt_and_partition(state, meta, elastic=True)
        else:
            sim._adopt_config(meta["engine_config"])
            # a domain checkpoint's flat state has its own slot count
            sim.engine.cfg = dataclasses.replace(sim.engine.cfg, capacity=state.capacity)
            sim.state = state
        sim.current_step = int(meta["current_step"])
        sim._sync_host()
        return sim

    def __getstate__(self):
        state = super().__getstate__()
        state["engine"] = None  # holds device handles; rebuilt on resume
        # the exact static config must survive: capacities decide deferred
        # divisions, so a bit-exact resume needs the same EngineConfig
        if self.engine is None:
            state["_engine_cfg"] = None
        elif self._is_domain:
            state["_engine_cfg"] = ("domain", domain_config_to_meta(self.engine.cfg))
        else:
            state["_engine_cfg"] = config_to_meta(self.engine.cfg)
        if self.state is not None:
            state["state"] = self._host()  # host numpy, never tensors
        state["_host_state"] = None  # never persist the cache itself
        return state

    def __setstate__(self, state):
        cfg_meta = state.pop("_engine_cfg", None)
        super().__setstate__(state)
        if self.state is not None:
            # placed on the device by steps(), after start() sets the device
            self._resume = (self.state, cfg_meta)
            self.state = None
