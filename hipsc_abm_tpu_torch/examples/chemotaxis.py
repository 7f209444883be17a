"""Chemotaxis: a second custom model on the framework and the ops library
(port of ``examples/chemotaxis.py``).

Where ``minimal_abm.py`` exercises the host-side registration and lifecycle
surface, this model shows the pattern for fast custom models: the per-step
compute is one function on the device built from the reusable ops (the FTCS
lattice, ``sample_concentration`` and ``deposit_morphogen`` of
``ops.diffusion``; on the card the FTCS kernel, ``ops.ftcs``), and the
framework holds the agents, outputs and lifecycle.

The model: foragers in a dish with an attractant source at the centre. Each
step the attractant diffuses (subcycled FTCS, reflecting walls), every agent
senses the field at +-h around itself (nearest-gridpoint samples), climbs
the gradient with a noisy step, and eats attractant where it stands (a
negative 4-point deposit). Agents log how much they have eaten.

Run:  python -m hipsc_abm_tpu_torch.examples.chemotaxis -n forage -m 0 [-d cpu]
"""

import os

import numpy as np
import torch

from hipsc_abm_tpu_torch.ops import diffusion as diff_ops
from hipsc_abm_tpu_torch.ops import rng
from hipsc_abm_tpu_torch.ops.ftcs import ftcs_diffuse_cuda
from hipsc_abm_tpu_torch.simulation import Simulation
from hipsc_abm_tpu_torch.utils import cli
from hipsc_abm_tpu_torch.utils.profiling import record_time

SPAT_RES = 10.0  # um between lattice points
DIFFUSE_CONST = 25.0  # um^2/s
DIFFUSE_DT = 0.2  # s per FTCS subcycle (stable: dt < h^2/(4 D))
SUBCYCLES = 30
MAX_C = 5.0
DEGRADATION = 0.02  # fraction lost per step
SOURCE_AMOUNT = 40.0  # attractant added at the center per step
SPEED = 4.0  # um per step along the sensed gradient
NOISE = 1.0  # um of isotropic jitter per step
EAT_RATE = 0.25  # fraction of the local concentration consumed per step


def chemotaxis_step(field, locs, key, box, nx: int, ny: int):
    """One step on the field's device: source -> diffuse -> sense -> move ->
    eat. ``key`` is a host threefry key (``ops.rng``). Returns (field',
    locs', eaten, key'); a function of its inputs alone."""
    field = field.clone()
    field[nx // 2, ny // 2] += SOURCE_AMOUNT
    dts = np.full((SUBCYCLES,), DIFFUSE_DT, np.float32)
    # the kernel on the card, its plain version on the CPU
    field = ftcs_diffuse_cuda(field, dts, DIFFUSE_CONST, SPAT_RES * SPAT_RES, MAX_C,
                              DEGRADATION)

    # finite-difference sense: nearest-gridpoint samples at +-h per axis
    def sample(dx, dy):
        offset = torch.tensor([dx, dy, 0.0], dtype=torch.float32, device=locs.device)
        return diff_ops.sample_concentration(field, locs + offset, SPAT_RES)

    h = SPAT_RES
    gx = sample(h, 0.0) - sample(-h, 0.0)
    gy = sample(0.0, h) - sample(0.0, -h)
    grad = torch.stack([gx, gy, torch.zeros_like(gx)], dim=1)
    norm = torch.linalg.vector_norm(grad, dim=1, keepdim=True)
    direction = torch.where(norm > 0.0, grad / torch.where(norm > 0, norm, 1.0), 0.0)

    key, sub = rng.split(key)
    jitter = NOISE * rng.random_normal(sub, tuple(locs.shape)).to(locs.device)
    jitter[:, 2] = 0.0
    locs = torch.minimum(torch.clamp(locs + SPEED * direction + jitter, min=0.0), box)

    # consume: a negative 4-point deposit (the fixed-order sum), then >= 0
    local = diff_ops.sample_concentration(field, locs, SPAT_RES)
    eaten = EAT_RATE * local
    field = diff_ops.deposit_morphogen(field, locs, -eaten, SPAT_RES)
    field = torch.clamp(field, min=0.0)
    return field, locs, eaten, key


class Chemotaxis(Simulation):
    def agent_initials(self):
        self.add_agents(self.num_to_start)
        self.agent_array(
            "locations",
            override=self._np_rng.random((self.number_agents, 3))
            * np.array([*self.size[:2], 0.0]),
        )
        self.agent_array("radii", func=lambda: 3.0)
        self.agent_array("food", dtype=float)

        nx = int(self.size[0] / SPAT_RES) + 1
        ny = int(self.size[1] / SPAT_RES) + 1
        self.attractant = torch.zeros((nx, ny), dtype=torch.float32, device=self.device)
        self._key = rng.prng_key(getattr(self, "seed", 0) or 0)
        self._box = torch.tensor([self.size[0], self.size[1], 0.0], dtype=torch.float32,
                                 device=self.device)

    @record_time
    def forage(self):
        nx, ny = self.attractant.shape
        field, locs, eaten, self._key = chemotaxis_step(
            self.attractant,
            torch.as_tensor(np.asarray(self.locations, np.float32), device=self.device),
            self._key, self._box, nx=nx, ny=ny,
        )
        self.attractant = field
        self.locations = locs.cpu().numpy()
        self.food = self.food + eaten.cpu().numpy()

    def steps(self):
        if self.record_initial_step:
            self.record_initials()
        for self.current_step in range(self.beginning_step, self.end_step + 1):
            self.info()
            self.forage()
            self.step_image()
            self.step_values()
            self.temp()
            self.data()
        self.create_video()


if __name__ == "__main__":
    Chemotaxis.start(os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs"),
                     device=cli.get_device())
