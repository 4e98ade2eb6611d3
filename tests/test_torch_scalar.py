"""The port's copied scalar oracle equals the JAX package's.

``repro_torch.core.engine.Sparseloop.evaluate`` (dataflow -> sparse ->
micro-architecture, copied without change) must reproduce
``repro.core.engine.Sparseloop.evaluate`` to <= 1e-12 relative on every
preset design and every density kind, with the inputs carried across by
``repro_torch.interop.from_reference``."""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import Sparseloop as RefSparseloop  # noqa: E402
from repro.core import matmul as ref_matmul  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro.core.mapper import MapspaceConstraints, _nests  # noqa: E402
from repro_torch.core import Sparseloop  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

M = K = N = 16
PRESETS = ("dense_design", "bitmask_design", "coordinate_list_design",
           "eyeriss_like", "eyeriss_v2_like", "scnn_like", "extensor_like",
           "stc_like", "dstc_like", "tpu_nm_design")
DENSITIES = {
    "dense": None,
    "uniform": {"A": ("uniform", 0.3), "B": ("uniform", 0.55)},
    "structured": {"A": ("uniform", 0.4),
                   "B": ("structured", {"n": 2, "m": 4})},
    "banded": {"A": ("banded", {"rows": M, "cols": K, "half_band": 2}),
               "B": ("uniform", 0.5)},
    "actual": {"A": ("actual", (np.random.default_rng(3).random((M, K))
                                < 0.35).astype(float)),
               "B": ("uniform", 0.5)},
}


def _leaves(x, prefix=""):
    """Flatten a result dataclass into (path, value) pairs."""
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _leaves(x[k], f"{prefix}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, x


def _same(a, b, rel=1e-12):
    if isinstance(a, float) or isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)
    return a == b


@pytest.mark.parametrize("density", sorted(DENSITIES))
@pytest.mark.parametrize("preset", PRESETS)
def test_scalar_oracle_matches_reference(preset, density):
    ref_design = getattr(ref_presets, preset)()
    ref_wl = ref_matmul(M, K, N, densities=DENSITIES[density])
    design, wl = from_reference(ref_design), from_reference(ref_wl)
    assert design == from_reference(ref_design)       # rebuilt by value
    ref, port = RefSparseloop(ref_design), Sparseloop(design)
    nests = list(_nests(ref_wl, ref_design.arch.num_levels,
                        MapspaceConstraints(budget=6, seed=1)))
    assert nests
    for ref_nest in nests:
        nest = from_reference(ref_nest)
        for check in (True, False):
            want = ref.evaluate(ref_wl, ref_nest, check_capacity=check)
            got = port.evaluate(wl, nest, check_capacity=check)
            pairs = list(zip(_leaves(got.result), _leaves(want.result)))
            assert len(pairs) == len(list(_leaves(want.result)))
            for (path, g), (_, w) in pairs:
                assert _same(g, w), (preset, density, path, g, w)
            assert _same(got.dense.dense_computes,
                         want.dense.dense_computes)


def test_from_reference_keeps_names_and_enums():
    ref_design = ref_presets.scnn_like()
    design = from_reference(ref_design)
    assert type(design).__module__ == "repro_torch.core.engine"
    assert design.arch.canonical() == ref_design.arch.canonical()
    for a, b in zip(design.safs.actions, ref_design.safs.actions):
        assert type(a.kind).__module__ == "repro_torch.core.taxonomy"
        assert a.kind.name == b.kind.name and a.leaders == b.leaders
    assert from_reference(design) is design   # port objects pass through
