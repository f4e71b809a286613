"""Elastic scaling and straggler/failure handling: the JAX package's
``repro/distributed/elastic.py`` over ``torch.distributed``.

On 1000+-node fleets the failure model is: a pod (or node) drops, the job
controller rebuilds the mesh without it, and training resumes from the last
checkpoint — checkpoints store logical arrays (training/checkpoint.py), so a
restore onto any mesh shape is well-defined.  This module provides the
controller-side pieces:

  * ``plan_remesh``  — choose a new mesh shape after losing devices,
  * ``build_mesh``   — a ``DeviceMesh`` over the surviving ranks,
  * ``ElasticController`` — restart loop: run -> failure -> remesh -> restore,
  * ``StragglerPolicy`` — per-step deadline tracking; a host that repeatedly
    exceeds the deadline is reported for exclusion at the next remesh
    (SPMD steps are globally synchronous, so mitigation == exclusion, not
    work-stealing).

A device is a rank of the default process group; ``build_mesh`` needs one
(``torch.distributed.init_process_group``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axis_names: tuple
    devices_used: int


def plan_remesh(n_devices: int, model_parallel: int,
                prefer_pods: bool = True) -> MeshPlan:
    """Largest (pod, data, model) grid that fits the surviving devices while
    preserving the model-parallel degree (params resharding across a changed
    TP degree is a different checkpoint layout; elastic rescale keeps TP
    fixed and flexes data/pod)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with {n_devices} devices")
    data = n_devices // model_parallel
    # prefer a pod axis when the data extent splits evenly in 2
    if prefer_pods and data % 2 == 0 and data >= 4:
        return MeshPlan((2, data // 2, model_parallel), ("pod", "data", "model"),
                        2 * (data // 2) * model_parallel)
    return MeshPlan((data, model_parallel), ("data", "model"),
                    data * model_parallel)


def build_mesh(plan: MeshPlan, devices=None, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``plan``'s shape over the first
    ``plan.devices_used`` of ``devices`` (ranks of the default process
    group; all of them by default)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    devices = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if len(devices) < plan.devices_used:
        raise ValueError("not enough devices for plan")
    ranks = torch.tensor(devices[: plan.devices_used]).reshape(plan.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=plan.axis_names)


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 2.0  # x median step time
    strikes_to_exclude: int = 3
    window: int = 50

    def __post_init__(self):
        self._times: list[float] = []
        self._strikes: dict[int, int] = {}

    def observe(self, host_id: int, step_time: float) -> None:
        self._times.append(step_time)
        self._times = self._times[-self.window:]
        med = sorted(self._times)[len(self._times) // 2]
        if step_time > self.deadline_factor * med and len(self._times) >= 5:
            self._strikes[host_id] = self._strikes.get(host_id, 0) + 1
        else:
            self._strikes[host_id] = 0

    def excluded_hosts(self) -> list[int]:
        return [h for h, s in self._strikes.items() if s >= self.strikes_to_exclude]


class ElasticController:
    """Run a restartable job; on simulated/real device loss, re-plan the mesh
    and restart from the latest checkpoint."""

    def __init__(self, run_fn: Callable[[object], dict], model_parallel: int,
                 device_type: str = "cuda"):
        self.run_fn = run_fn  # receives a DeviceMesh, returns result dict
        self.model_parallel = model_parallel
        self.device_type = device_type
        self.restarts = 0

    def run(self, max_restarts: int = 3, fail_injector: Optional[Callable] = None):
        import torch.distributed as dist

        devices = list(range(dist.get_world_size()))
        while True:
            plan = plan_remesh(len(devices), self.model_parallel)
            mesh = build_mesh(plan, devices, self.device_type)
            try:
                if fail_injector is not None:
                    fail_injector(self.restarts)
                return self.run_fn(mesh)
            except DeviceLossError as e:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                devices = [d for d in devices if d not in e.lost_ids]
                time.sleep(0.01)  # backoff placeholder


class DeviceLossError(RuntimeError):
    def __init__(self, lost_ids):
        super().__init__(f"lost devices {lost_ids}")
        self.lost_ids = set(lost_ids)
