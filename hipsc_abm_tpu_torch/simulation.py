"""Framework layer: the ``Simulation`` base class (port of
``hipsc_abm_tpu/simulation.py``, the pythonabm-compatible API).

- ``start()`` with modes 0 (new), 1 (continue), 2 (video) and 3 (zip);
- the registration API ``add_agents`` / ``agent_array`` / ``agent_graph``;
- ``get_neighbors(graph_name, distance, clear=True)``, a fixed-radius search
  on the sorted grid of ``ops.neighbors`` into an ``AgentGraph`` edge list;
- the outputs ``step_values`` / ``step_image`` / ``temp`` / ``data`` /
  ``create_video`` / ``info`` / ``record_initials`` and ``random_vector``;
- ``templates/general.yaml`` and ``paths.yaml`` read unchanged.

Every simulation has an explicit torch ``device``: ``"cuda"`` (the default)
needs a CUDA device and raises without one; ``"cpu"`` runs everything on the
host. The template's ``cuda`` key is read and ignored. Models with a fused
device loop (``models.hipsc``) bypass ``get_neighbors``.
"""

from __future__ import annotations

import copy
import math
import os
import pickle
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hipsc_abm_tpu_torch.ops import neighbors as nbr_ops
from hipsc_abm_tpu_torch.params import GeneralParams
from hipsc_abm_tpu_torch.utils import cli
from hipsc_abm_tpu_torch.utils import io as io_utils
from hipsc_abm_tpu_torch.utils.config import check_output_dir, template_params
from hipsc_abm_tpu_torch.utils.profiling import record_time


class AgentGraph:
    """Host-side agent adjacency (the reference's ``Graph(igraph.Graph)``):
    an undirected edge list with igraph-style accessors, and the capacity
    counters the reference keeps for its doubling loops."""

    def __init__(self, num_vertices: int = 0):
        self.num_vertices = int(num_vertices)
        self.edges = np.zeros((0, 2), dtype=np.int64)
        self.max_neighbors = 1
        self.max_agents = 1
        self._adjacency: Optional[List[np.ndarray]] = None

    # -- construction ------------------------------------------------------

    def set_edges(self, edges: np.ndarray) -> None:
        self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self._adjacency = None

    def add_edges(self, edges: np.ndarray) -> None:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.edges = np.concatenate([self.edges, edges], axis=0)
        self._adjacency = None

    def delete_edges(self, indices=None) -> None:
        if indices is None:
            self.edges = np.zeros((0, 2), dtype=np.int64)
        else:
            self.edges = np.delete(self.edges, np.asarray(indices, dtype=np.int64), axis=0)
        self._adjacency = None

    def simplify(self) -> None:
        """Drop duplicate undirected edges (igraph ``simplify``)."""
        if len(self.edges) == 0:
            return
        lo = np.minimum(self.edges[:, 0], self.edges[:, 1])
        hi = np.maximum(self.edges[:, 0], self.edges[:, 1])
        self.edges = np.unique(np.stack([lo, hi], axis=1), axis=0)
        self._adjacency = None

    def add_vertex(self, n: int = 1) -> None:
        self.num_vertices += int(n)
        self._adjacency = None

    def delete_vertices(self, indices) -> None:
        """Remove vertices and renumber, dropping incident edges (igraph
        ``delete_vertices``)."""
        indices = np.unique(np.asarray(indices, dtype=np.int64))
        if len(indices) == 0:
            return
        keep = np.ones(self.num_vertices, dtype=bool)
        keep[indices] = False
        remap = np.cumsum(keep) - 1
        if len(self.edges):
            edge_ok = keep[self.edges[:, 0]] & keep[self.edges[:, 1]]
            self.edges = remap[self.edges[edge_ok]]
        self.num_vertices -= len(indices)
        self._adjacency = None

    # -- queries -----------------------------------------------------------

    def _build_adjacency(self) -> List[np.ndarray]:
        if self._adjacency is None:
            if len(self.edges) == 0:
                self._adjacency = [np.empty(0, dtype=np.int64)
                                   for _ in range(self.num_vertices)]
            else:
                src = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
                dst = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
                order = np.argsort(src, kind="stable")
                splits = np.searchsorted(src[order], np.arange(1, self.num_vertices))
                self._adjacency = np.split(dst[order], splits)
        return self._adjacency

    def neighbors(self, index: int) -> list:
        return self._build_adjacency()[index].tolist()

    def num_neighbors(self, index: int) -> int:
        return len(self._build_adjacency()[index])

    def get_edgelist(self) -> np.ndarray:
        return self.edges.copy()

    def vcount(self) -> int:
        return self.num_vertices

    def ecount(self) -> int:
        return len(self.edges)


class Simulation:
    """Base Simulation: agent container, neighbour search, lifecycle, outputs."""

    def __init__(self, name: str, output_path: str, device="cuda"):
        self._place(device)
        self.name = name
        self.separator = os.path.sep

        self.main_path = output_path + self.name + self.separator
        self.templates_path = os.path.abspath("templates") + self.separator
        if not os.path.isdir(self.templates_path):
            # the repository's example templates, so the framework runs anywhere
            here = os.path.dirname(os.path.abspath(__file__))
            packaged = os.path.join(here, "..", "examples", "templates")
            self.templates_path = os.path.abspath(packaged) + self.separator
        self.images_path = self.main_path + name + "_images" + self.separator
        self.values_path = self.main_path + name + "_values" + self.separator

        self.number_agents = 0
        self.current_step = 0
        self.beginning_step = 1
        self.agent_array_names: List[str] = []
        self.graph_names: List[str] = []
        self.method_times: Dict[str, float] = {}

        keys = template_params(self.templates_path + "general.yaml")
        self.num_to_start = keys["num_to_start"]
        self.cuda = keys["cuda"]  # read for template compatibility; `device` decides
        self.end_step = keys["end_step"]
        self.size = np.array(keys["size"], dtype=float)
        self.output_values = keys["output_values"]
        self.output_images = keys["output_images"]
        self.record_initial_step = keys["record_initial_step"]
        self.image_quality = keys["image_quality"]
        self.video_quality = keys["video_quality"]
        self.fps = keys["fps"]
        self.seed = keys.get("seed", 0)
        # false: no per-step pickle; mode 1 resumes from the npz checkpoint
        self.temp_pickle = bool(keys.get("temp_pickle", True))
        # the multi-device domain engine's tile grid (None = one device)
        tiles = keys.get("domain_tiles")
        if tiles is not None:
            tiles = (int(tiles), 1) if np.isscalar(tiles) else (int(tiles[0]), int(tiles[1]))
        self.domain_tiles = tiles
        # outputs every N steps instead of every step
        self.output_interval = max(1, int(keys.get("output_interval", 1)))
        self.general_params = GeneralParams.from_dict({**keys, "size": list(keys["size"])})

        self._np_rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------
    # default model hooks
    # ------------------------------------------------------------------

    def agent_initials(self):
        self.add_agents(self.num_to_start)
        self.agent_array("locations",
                         override=self._np_rng.random((self.number_agents, 3)) * self.size)
        self.agent_array("radii", func=lambda: 5)

    def steps(self):
        if self.record_initial_step:
            self.record_initials()
        for self.current_step in range(self.beginning_step, self.end_step + 1):
            self.info()
            self.step_image()
            self.step_values()
            self.temp()
            self.data()
        self.create_video()

    # ------------------------------------------------------------------
    # registration API
    # ------------------------------------------------------------------

    def add_agents(self, number: int, agent_type: Optional[str] = None) -> None:
        begin = self.number_agents
        self.number_agents += number
        if agent_type is not None:
            if not hasattr(self, "agent_types"):
                self.agent_types = {}
            self.agent_types[agent_type] = (begin, self.number_agents)

    def agent_array(self, array_name: str, agent_type: Optional[str] = None, dtype=float,
                    vector: Optional[int] = None, func=None, override=None) -> None:
        if override is not None:
            if override.shape[0] != self.number_agents:
                raise Exception(
                    "Length of override array does not match number of agents in simulation!")
            self.__dict__[array_name] = np.asarray(override)
            if array_name not in self.agent_array_names:
                self.agent_array_names.append(array_name)
        elif not hasattr(self, array_name):
            self.agent_array_names.append(array_name)
            size = self.number_agents if vector is None else (self.number_agents, vector)
            if dtype in (str, object):
                self.__dict__[array_name] = np.empty(size, dtype=object)
            else:
                self.__dict__[array_name] = np.zeros(size, dtype=dtype)

        if func is not None:
            if agent_type is None:
                begin, end = 0, self.number_agents
            else:
                begin, end = self.agent_types[agent_type]
            for i in range(begin, end):
                self.__dict__[array_name][i] = func()

    def agent_graph(self, graph_name: str) -> None:
        self.__dict__[graph_name] = AgentGraph(self.number_agents)
        self.graph_names.append(graph_name)

    # ------------------------------------------------------------------
    # neighbour search
    # ------------------------------------------------------------------

    def _auto_run_cap(self, distance: float) -> int:
        """The per-run window width (3 adjacent bins) from the current
        density."""
        locs = np.asarray(self.locations[: self.number_agents])
        coords = np.floor(locs / distance).astype(np.int64)
        if len(coords) == 0:
            return 8
        _, counts = np.unique(coords, axis=0, return_counts=True)
        return max(8, int(math.ceil(counts.max() * 3 * 1.25 / 8.0) * 8))

    def get_neighbors(self, graph_name: str, distance: float, clear: bool = True):
        """Fixed-radius neighbour search into the graph's host edge list
        (each undirected edge once, lower index first). It builds a dense
        (agents, window) candidate mask per call, on ``self.device``."""
        graph: AgentGraph = self.__dict__[graph_name]
        n = self.number_agents
        graph.num_vertices = n

        run_cap = max(self._auto_run_cap(distance), graph.max_agents)
        graph.max_agents = run_cap
        spec = nbr_ops.GridSpec.from_box(tuple(self.size), float(distance), run_cap)

        locs = torch.as_tensor(np.asarray(self.locations[:n]), dtype=torch.float32,
                               device=self.device)
        alive = torch.ones((n,), dtype=torch.bool, device=self.device)
        cand_idx, mask, max_run = nbr_ops.neighbor_search(spec, locs, alive, float(distance))
        if int(max_run) > run_cap:
            raise RuntimeError(f"neighbour run of {int(max_run)} exceeds run_cap {run_cap}")

        rows, cols = np.nonzero(mask.cpu().numpy())
        partners = cand_idx.cpu().numpy()[rows, cols]
        keep = rows < partners  # each undirected edge once
        edges = np.stack([rows[keep], partners[keep]], axis=1)
        graph.max_neighbors = max(graph.max_neighbors, int(np.max(
            np.bincount(rows, minlength=1))) if len(rows) else 1)

        if clear:
            graph.set_edges(edges)
        else:
            graph.add_edges(edges)
            graph.simplify()
        return graph

    # ------------------------------------------------------------------
    # outputs / lifecycle
    # ------------------------------------------------------------------

    @record_time
    def temp(self):
        """The pickle checkpoint, serialized on the background writer. A
        shallow clone pins this step's bindings: the step loop rebinds host
        arrays and never mutates them in place."""
        clone = copy.copy(self)
        path = self.main_path + f"{self.name}_temp.pkl"

        def write():
            with open(path, "wb") as file:
                file.write(pickle.dumps(clone, -1))

        io_utils.submit_output(write)

    @record_time
    def step_values(self, arrays: Optional[List[str]] = None):
        if self.output_values:
            if arrays is None:
                arrays = self.agent_array_names
            os.makedirs(self.values_path, exist_ok=True)
            path = self.values_path + f"{self.name}_values_{self.current_step}.csv"
            # copies: a model may move its arrays in place before the
            # background writer formats them
            snap = {name: np.array(self.__dict__[name][: self.number_agents])
                    for name in arrays}
            io_utils.submit_output(lambda: io_utils.write_values_csv(
                path, {k: np.asarray(v) for k, v in snap.items()}, list(arrays)))

    @record_time
    def step_image(self, background=(0, 0, 0), origin_bottom=True):
        if self.output_images:
            os.makedirs(self.images_path, exist_ok=True)
            n = self.number_agents
            colors = np.tile(np.array([[255, 50, 50]], dtype=np.uint8), (n, 1))
            image = io_utils.render_step_image(
                np.asarray(self.locations[:n]), np.asarray(self.radii[:n]), colors,
                tuple(self.size), self.image_quality, background=background,
                origin_bottom=origin_bottom)
            io_utils.save_image_png(
                self.images_path + f"{self.name}_image_{self.current_step}.png", image)

    def data(self):
        io_utils.append_data_csv(
            self.main_path + f"{self.name}_data.csv", self.current_step, self.number_agents,
            time.perf_counter() - self.step_start, io_utils.process_memory_mb(),
            self.method_times)

    def create_video(self):
        io_utils.flush_outputs()  # the frames must exist before assembly
        out = io_utils.create_video_from_images(
            self.images_path, self.main_path + f"{self.name}_video.mp4",
            self.video_quality, self.fps, progress=cli.progress_bar)
        if out:
            print("\nCreating video...")
        print("\n\nDone!\n")

    def info(self):
        self.step_start = time.perf_counter()
        print("Step: " + str(self.current_step))
        print("Number of agents: " + str(self.number_agents))

    def random_vector(self) -> np.ndarray:
        """A random unit vector on the circle (2D) or sphere (3D)."""
        theta = self._np_rng.random() * 2 * math.pi
        if self.size[2] == 0:
            return np.array([math.cos(theta), math.sin(theta), 0])
        phi = self._np_rng.random() * 2 * math.pi
        radius = math.cos(phi)
        return np.array([radius * math.cos(theta), radius * math.sin(theta), math.sin(phi)])

    def record_initials(self):
        if self.current_step == 0:
            self.step_values()
            self.step_image()

    @classmethod
    def resume_from_npz(cls, name: str, output_dir: str, device="cuda") -> "Simulation":
        """Mode 1 without a ``_temp.pkl``: the base framework has only the
        pickle; models with an npz state checkpoint override this."""
        raise FileNotFoundError(
            f"no {name}_temp.pkl found and {cls.__name__} has no npz resume path — was the "
            "run made with temp_pickle: false on a model without a state checkpoint?")

    def __copy__(self):
        """The ``temp()`` snapshot clone, without ``__getstate__``'s device
        round trip. It shares the bindings except what the live object
        mutates in place: the numpy RNG, the engine (growth rebinds its
        ``cfg``, and the checkpoint must carry this step's config) and
        ``method_times``."""
        cls = self.__class__
        clone = cls.__new__(cls)
        clone.__dict__.update(self.__dict__)
        clone._np_rng = pickle.loads(pickle.dumps(self._np_rng))
        eng = clone.__dict__.get("engine")
        if eng is not None:
            eng_clone = type(eng).__new__(type(eng))
            eng_clone.__dict__.update(eng.__dict__)
            clone.engine = eng_clone
        clone.method_times = dict(self.method_times)
        return clone

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_np_rng"] = pickle.dumps(self._np_rng)
        return state

    def __setstate__(self, state):
        rng = state.pop("_np_rng", None)
        self.__dict__.update(state)
        self._np_rng = pickle.loads(rng) if isinstance(rng, bytes) else np.random.default_rng()

    def _place(self, device) -> None:
        """Run on ``device`` from here on (a resumed pickle carries the
        device of the run that wrote it); raises for CUDA without a card."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}(device='cuda') needs a CUDA device")
        self.device = device

    # ------------------------------------------------------------------
    # entry point
    # ------------------------------------------------------------------

    @classmethod
    def start(cls, output_dir: Optional[str] = None, argv: Optional[list] = None,
              device="cuda"):
        """Configure and run the model in one of four modes; the output
        directory comes from the argument or from ``paths.yaml``."""
        if output_dir is None:
            output_dir = check_output_dir()
        elif not output_dir.endswith(os.path.sep):
            output_dir += os.path.sep
        os.makedirs(output_dir, exist_ok=True)

        name, mode = cli.get_name_mode(argv)

        if mode == 0:
            name = cli.check_new_sim(name, output_dir)
            sim = cls(name, output_dir, device=device)
            # snapshot the model's directory into the output directory
            try:
                shutil.copytree(os.getcwd(), sim.main_path + name + "_copy",
                                ignore=shutil.ignore_patterns("__pycache__", ".git", "outputs"))
            except (OSError, shutil.Error):
                pass
            sim.agent_initials()
            sim.steps()
            return sim

        name = cli.check_previous_sim(name, output_dir)
        if mode == 1:
            file_name = output_dir + name + os.sep + name + "_temp.pkl"
            if os.path.isfile(file_name):
                with open(file_name, "rb") as file:
                    sim = pickle.load(file)
                sim._place(device)
            else:
                # runs with temp_pickle: false checkpoint only the npz state
                sim = cls.resume_from_npz(name, output_dir, device=device)
            sim.beginning_step = sim.current_step + 1
            sim.end_step = cli.get_final_step(argv)
            sim.steps()
            return sim
        elif mode == 2:
            sim = cls(name, output_dir, device=device)
            sim.create_video()
            return sim
        elif mode == 3:
            print('Compressing "' + name + '" simulation...')
            shutil.make_archive(output_dir + name, "zip", root_dir=output_dir, base_dir=name)
            print("Done!")
            return None
        else:
            raise Exception(f"Unknown mode: {mode}")
