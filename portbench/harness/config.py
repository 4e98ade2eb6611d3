"""A configuration file (``configs/<name>.json``) and what it builds on
each side: the program's design and workloads (``repro_torch``) and the
reference's (``portbench.reference``), from the same numbers."""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    M: int
    K: int
    N: int
    density: dict

    def densities(self) -> dict:
        return {t: ("uniform", float(d)) for t, d in self.density.items()}


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    design: dict
    spatial_by_name: dict
    check_capacity: bool
    precision: str
    layers: tuple[Layer, ...]

    @staticmethod
    def load(name: str) -> "Config":
        raw = json.loads((ROOT / "configs" / f"{name}.json").read_text())
        if raw["name"] != name:
            raise ValueError(f"configs/{name}.json names itself "
                             f"{raw['name']!r}")
        return Config(name=name, design=raw["design"],
                      spatial_by_name=raw.get("spatial", {}),
                      check_capacity=bool(raw.get("check_capacity", True)),
                      precision=raw.get("precision", "float64"),
                      layers=tuple(Layer(**lay) for lay in raw["layers"]))

    # the two sides build from the same preset names and numbers
    def _design(self, core, presets):
        """The SAF preset ``design.preset`` on the architecture of
        ``design.arch``: its storage levels (outermost first; a capacity
        of null is unbounded) and compute, as the file lists them."""
        spec = self.design["arch"]
        levels = tuple(core.StorageLevel(
            lv["name"], math.inf if lv["capacity_words"] is None
            else float(lv["capacity_words"]),
            float(lv["bandwidth_words_per_cycle"]), float(lv["read_energy_pj"]),
            float(lv["write_energy_pj"]), float(lv["gated_energy_pj"]))
            for lv in spec["levels"])
        comp = spec["compute"]
        arch = core.Architecture(name=spec["name"], levels=levels,
                                 compute=core.ComputeLevel(
                                     comp["name"], int(comp["instances"]),
                                     float(comp["mac_energy_pj"]),
                                     float(comp["gated_energy_pj"]),
                                     float(comp["throughput"])))
        return getattr(presets, self.design["preset"])(arch)

    def program_design(self):
        from repro_torch import core
        from repro_torch.core import presets
        return self._design(core, presets)

    def reference_design(self):
        from .. import reference
        return self._design(reference, reference.presets)

    def spatial(self, design) -> dict:
        """``{level index (innermost first): {rank: bound}}``."""
        names = design.level_names
        return {names.index(lvl): dict(d)
                for lvl, d in self.spatial_by_name.items()}

    def program_workload(self, layer: Layer):
        from repro_torch.core import matmul
        return matmul(layer.M, layer.K, layer.N,
                      densities=layer.densities(), name=layer.name)

    def reference_workload(self, layer: Layer):
        from ..reference import matmul
        return matmul(layer.M, layer.K, layer.N,
                      densities=layer.densities(), name=layer.name)
