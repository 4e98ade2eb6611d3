"""Device selection for the port's entry points.

Every entry point that runs the batched engine or a kernel takes a
``device`` argument.  ``None`` means the CUDA card; the CPU is used only
when the caller asks for it (``device="cpu"``, as the tests do).  There
is no silent fallback: without CUDA and without an explicit device the
call raises.

:class:`PopulationMesh` names the devices one population's candidate
axis is split over (``BatchedModel.evaluate(..., mesh=)``).
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a concrete ``torch.device`` (``None`` -> the current
    CUDA device; raises when CUDA is missing)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run on the "
                "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class PopulationMesh:
    """The devices a population's candidate axis is split over: the
    port's counterpart of a one-axis ``jax.sharding.Mesh`` (axis
    ``"pop"``) under ``shard_map``.  One process drives every device, as
    JAX's single controller does; shard ``i`` of a padded population
    runs on ``devices[i]``.

    A mesh that names one device more than once is *simulated*: its
    shards run in turn on that device, the counterpart of the JAX
    package's forced host devices
    (``--xla_force_host_platform_device_count``).  It exists for tests
    and smoke runs and says so when printed."""

    devices: tuple
    axis_names: tuple = ("pop",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a PopulationMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(
            resolve_device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def simulated(self) -> bool:
        """True when a device repeats (its shards run in turn)."""
        return len(set(self.devices)) < len(self.devices)

    def __str__(self) -> str:
        names = ", ".join(str(d) for d in dict.fromkeys(self.devices))
        tag = " simulated" if self.simulated else ""
        return f"PopulationMesh({self.size}{tag} shards on {names})"
