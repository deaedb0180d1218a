"""Cluster runtime for elastic serving and training — port of
``repro/runtime/cluster.py``'s ``ClusterSim`` (:69), ``elastic_remesh``
(:32) and ``FailureInjector`` (:22): node liveness from heartbeats, the
largest (data, model) mesh over the surviving ranks, and scheduled node
failures for the trainer.

The survivor mesh takes ranks ``0..n-1`` of the running process group, as
the reference takes ``jax.devices()[:n]``.  Building it is a collective
call: every rank of the world makes it, those outside the mesh included
(``DeviceMesh`` makes its groups with ``new_group``).  ``FailureInjector``
raises the trainer's ``NodeFailure`` at scheduled steps.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import mesh_device_type
from repro_torch.train.trainer import NodeFailure


@dataclasses.dataclass
class FailureInjector:
    """Raise NodeFailure when the trainer reaches a scheduled step (each
    scheduled step once)."""
    schedule: dict[int, str]    # step -> failure description
    fired: set = dataclasses.field(default_factory=set)

    def __call__(self, step: int) -> None:
        if step in self.schedule and step not in self.fired:
            self.fired.add(step)
            raise NodeFailure(f"step {step}: {self.schedule[step]}")


def elastic_remesh(n_devices: int | None = None, *, min_model: int = 1,
                   prefer: str = "model") -> DeviceMesh:
    """Largest (data, model) mesh over the first ``n_devices`` ranks.

    ``prefer="model"`` (trainer recovery) keeps the model dim as large as
    possible (16, 8, 4, 2 or 1 dividing n, at least ``min_model``) and puts
    the remainder on data; ``prefer="data"`` (serving recovery) puts every
    surviving rank on the data dim, shape (n / min_model, min_model)."""
    world = dist.get_world_size()
    n = n_devices if n_devices is not None else world
    if n <= 0:
        raise ValueError(
            f"elastic_remesh needs at least one surviving device, got "
            f"n_devices={n_devices!r}")
    if prefer not in ("model", "data"):
        raise ValueError(f"prefer must be 'model' or 'data', got {prefer!r}")
    n = min(n, world)
    if prefer == "data":
        model = max(min_model, 1)
        if n % model != 0:
            raise ValueError(
                f"{n} surviving devices not divisible by min_model={model}")
    else:
        model = 1
        for cand in (16, 8, 4, 2, 1):
            if cand <= n and n % cand == 0 and cand >= min_model:
                model = cand
                break
    data = n // model
    ranks = [[d * model + j for j in range(model)] for d in range(data)]
    return DeviceMesh(mesh_device_type(), ranks,
                      mesh_dim_names=("data", "model"))


class ClusterSim:
    """Tracks node liveness via heartbeats; feeds the elastic controller."""

    def __init__(self, n_nodes: int, heartbeat_timeout: float = 3.0):
        self.n_nodes = n_nodes
        self.timeout = heartbeat_timeout
        self.last_seen = {i: 0.0 for i in range(n_nodes)}
        self.dead: set[int] = set()
        self.clock = 0.0

    def tick(self, dt: float = 1.0, heartbeats: set | None = None) -> set:
        """Advance the clock by ``dt``; ``heartbeats`` (all nodes when None)
        refresh their last-seen time.  Returns the nodes newly declared
        dead (silent for longer than the timeout)."""
        self.clock += dt
        for i in (heartbeats if heartbeats is not None
                  else set(range(self.n_nodes))):
            if i not in self.dead:
                self.last_seen[i] = self.clock
        newly_dead = {
            i for i in range(self.n_nodes)
            if i not in self.dead and self.clock - self.last_seen[i]
            > self.timeout
        }
        self.dead |= newly_dead
        return newly_dead

    def kill(self, node: int) -> None:
        self.dead.add(node)

    @property
    def alive(self) -> int:
        return self.n_nodes - len(self.dead)
