"""A configuration file (``configs/<name>.json``) and what it builds on
each side: the program's design and workloads (``repro_torch``) and the
reference's (``portbench.reference``), from the same numbers.

The file's vocabulary, read alike by both sides:

* ``design.arch``: the storage levels, outermost first (a capacity of
  null is unbounded), and the compute level: the one statement of the
  architecture;
* ``design.preset``: a SAF preset of ``presets`` (Sparseloop Table 3) by
  name, and ``design.preset_args`` its keyword arguments.  A preset that
  takes ``arch`` is given the file's; for one that builds its own
  (``stc_like``, ``dstc_like``, ``tpu_nm_design``) its SAFs and name are
  put on the file's architecture.  Every level the SAFs name has to be a
  level of the file, and an argument that only sizes the preset's own
  architecture (:data:`ARCH_ARGS`) is refused;
* ``layers[].density[tensor]``: a number (uniform), or an object naming a
  kind: ``{"kind": "dense"}``, ``{"kind": "uniform", "density": d}``,
  ``{"kind": "structured", "n": 2, "m": 4}``, ``{"kind": "banded",
  "half_band": w}``, or a kind that the reference finds by name
  (``reference/kinds/<kind>.py``) with that kind's own keys.  ``banded``
  and a kind found by name get ``rows`` and ``cols`` from the tensor's
  shape in the layer (:data:`SHAPES`).

A malformed file raises ``ValueError`` at :meth:`Config.load`, naming the
file and the layer and tensor, or the argument, at fault.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: each tensor of a layer's GEMM, by the layer's sizes (rows, cols)
SHAPES = {"A": ("M", "K"), "B": ("K", "N"), "Z": ("M", "N")}
#: the keys beside ``kind`` of each kind the reference defines
KIND_KEYS = {"dense": (), "uniform": ("density",), "structured": ("n", "m"),
         "banded": ("half_band",)}
#: preset arguments that size only the preset's own architecture, which
#: the file's ``arch`` replaces
ARCH_ARGS = frozenset({"smem_bw"})
LAYER_KEYS = ("name", "M", "K", "N", "density")


def _whole(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def _share(x) -> bool:
    """A density: a number in (0, 1]."""
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and 0.0 < x <= 1.0)


def density_spec(d, rows: int, cols: int) -> tuple:
    """The workload's density spec ``(kind, params)`` of one tensor's
    entry ``d`` in the file; raises ``ValueError`` saying what is wrong."""
    from ..reference import density as refdensity
    if not isinstance(d, dict):
        if not _share(d):
            raise ValueError(f"a density is a number in (0, 1], got {d!r}")
        return ("uniform", float(d))
    kind = d.get("kind")
    if not isinstance(kind, str):
        raise ValueError(f"an object names its kind, got {d!r}")
    params = {k: v for k, v in d.items() if k != "kind"}
    if kind in KIND_KEYS:
        want = KIND_KEYS[kind]
        extra, missing = set(params) - set(want), set(want) - set(params)
        if extra or missing:
            raise ValueError(f"kind {kind!r} takes {list(want)}; unknown "
                             f"{sorted(extra)}, missing {sorted(missing)}")
    elif not refdensity.named_kind(kind):
        raise ValueError(f"kind {kind!r} is neither the reference's "
                         f"{sorted(KIND_KEYS)} nor a file reference/kinds/"
                         f"<kind>.py")
    elif {"rows", "cols"} & set(params):
        raise ValueError("rows and cols come from the layer's sizes")
    if kind == "dense":
        return ("dense", None)
    if kind == "uniform":
        if not _share(params["density"]):
            raise ValueError(f"density {params['density']!r} is not in (0, 1]")
        return ("uniform", float(params["density"]))
    if kind == "structured":
        n, m = params["n"], params["m"]
        if not (_whole(n) and _whole(m) and 1 <= n < m):
            raise ValueError(f"structured takes whole 1 <= n < m, got n {n!r}"
                             f" m {m!r}")
        return ("structured", {"n": n, "m": m})
    if kind == "banded" and not (_whole(params["half_band"])
                                 and params["half_band"] >= 0):
        raise ValueError(f"half_band {params['half_band']!r} is not a whole "
                         f"number >= 0")
    return (kind, dict(params, rows=rows, cols=cols))


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    M: int
    K: int
    N: int
    #: tensor name -> the workload's density spec ``(kind, params)``
    densities: dict


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
        """``configs/<name>.json``."""
        return Config.load_file(ROOT / "configs" / f"{name}.json", name)

    @staticmethod
    def load_file(path, name: str | None = None) -> "Config":
        """The configuration in ``path``, which has to name itself
        ``name`` where one is given."""
        path = Path(path)
        raw = json.loads(path.read_text())
        if name is not None and raw["name"] != name:
            raise ValueError(f"{path} names itself {raw['name']!r}, not "
                             f"{name!r}")
        layers = []
        for i, lay in enumerate(raw["layers"]):
            where = f"{path}: layer {lay.get('name', i)!r}"
            if sorted(lay) != sorted(LAYER_KEYS):
                raise ValueError(f"{where}: a layer has the keys "
                                 f"{list(LAYER_KEYS)}, got {sorted(lay)}")
            dens = {}
            for t, d in lay["density"].items():
                if t not in SHAPES:
                    raise ValueError(f"{where}: no tensor {t!r} (the GEMM's "
                                     f"are {sorted(SHAPES)})")
                rows, cols = (int(lay[k]) for k in SHAPES[t])
                try:
                    dens[t] = density_spec(d, rows, cols)
                except ValueError as exc:
                    raise ValueError(f"{where}, tensor {t!r}: {exc}") from None
            layers.append(Layer(lay["name"], int(lay["M"]), int(lay["K"]),
                                int(lay["N"]), dens))
        cfg = Config(name=raw["name"], design=raw["design"],
                     spatial_by_name=raw.get("spatial", {}),
                     check_capacity=bool(raw.get("check_capacity", True)),
                     precision=raw.get("precision", "float64"),
                     layers=tuple(layers))
        cfg._check(path)
        return cfg

    def _check(self, path) -> None:
        """What a run would find wrong only on the card: the preset and
        its arguments, the levels its SAFs name, and each density as the
        reference builds it."""
        from .. import reference
        from ..reference.density import make_density_model
        presets = reference.presets
        preset = getattr(presets, self.design["preset"], None)
        args = self.design.get("preset_args", {})
        if not callable(preset) or not isinstance(args, dict):
            raise ValueError(f"{path}: design.preset {self.design['preset']!r}"
                             f" is no preset, or preset_args no object")
        params = inspect.signature(preset).parameters
        for k in args:
            if k == "arch" or k not in params:
                raise ValueError(f"{path}: design.preset_args {k!r}: "
                                 f"{self.design['preset']} takes "
                                 f"{[p for p in params if p != 'arch']}")
            if k in ARCH_ARGS:
                raise ValueError(f"{path}: design.preset_args {k!r} sizes "
                                 f"only the preset's own architecture; the "
                                 f"file's design.arch states it")
        try:
            design = self.reference_design()
        except (TypeError, AttributeError) as exc:
            raise ValueError(f"{path}: design.preset "
                             f"{self.design['preset']!r}: {exc}") from None
        if not isinstance(design, reference.Design):
            raise ValueError(f"{path}: design.preset "
                             f"{self.design['preset']!r} builds no design")
        levels = set(design.level_names) | {"compute"}
        named = ({lvl for lvl, _ in design.safs.formats}
                 | {a.level for a in design.safs.actions})
        if named - levels:
            raise ValueError(f"{path}: design.preset {self.design['preset']!r}"
                             f" names levels {sorted(named - levels)} that "
                             f"design.arch has not ({sorted(levels)})")
        for lay in self.layers:
            for t, spec in lay.densities.items():
                rows, cols = (getattr(lay, k) for k in SHAPES[t])
                try:
                    make_density_model(spec, rows * cols)
                except (ValueError, KeyError, TypeError) as exc:
                    raise ValueError(f"{path}: layer {lay.name!r}, tensor "
                                     f"{t!r}: {exc!r}") from None

    # the two sides build from the same preset names and numbers
    def _design(self, core, presets):
        """The SAF preset ``design.preset`` (with ``design.preset_args``)
        on the architecture of ``design.arch``."""
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
        preset = getattr(presets, self.design["preset"])
        args = self.design.get("preset_args", {})
        if "arch" in inspect.signature(preset).parameters:
            return preset(arch, **args)
        own = preset(**args)
        return core.Design(arch=arch, safs=own.safs, name=own.name)

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
                      densities=dict(layer.densities), name=layer.name)

    def reference_workload(self, layer: Layer):
        from ..reference import matmul
        return matmul(layer.M, layer.K, layer.N,
                      densities=dict(layer.densities), name=layer.name)
