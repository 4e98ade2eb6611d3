"""The frozen reference against the port's own scalar model and batched
engine, on the benchmark's seeded legal mappings of both
configurations."""
from pathlib import Path

import numpy as np
import pytest

from portbench import reference as ref
from portbench.harness import judge, mappings
from portbench.harness.config import Config

CONFIGS = ("scnn-resnet50", "eyeriss-v2saf-mobilenet")
ROOT = Path(__file__).resolve().parents[2]


def _mappings(cfg, layer, n, seed):
    design = cfg.reference_design()
    wl = cfg.reference_workload(layer)
    return mappings.draw(wl.rank_bounds, design.arch.num_levels,
                         cfg.spatial(design), n, np.random.default_rng(seed))


def _config(name, request):
    """A cell's configuration, or ``conftest.STC`` for ``"stc"``."""
    return (Config.load_file(request.getfixturevalue("stc").path)
            if name == "stc" else Config.load(name))


@pytest.mark.parametrize("name", CONFIGS + ("stc",))
def test_reference_equals_the_port_scalar_model(name, request):
    """Both cells' configurations, and the 2:4 STC one (``conftest.STC``:
    another hierarchy, structured and dense operands)."""
    from repro_torch.core import Loop, LoopNest, Sparseloop
    cfg = _config(name, request)
    design = cfg.program_design()
    program = Sparseloop(design, device="cpu")
    reference = judge.Reference(cfg)
    valid = 0
    for li, layer in enumerate(cfg.layers):
        wl = cfg.program_workload(layer)
        ms = _mappings(cfg, layer, 24, 100 + li)
        for c in range(len(ms)):
            loops = mappings.loops(ms, c)
            got = program.evaluate(wl, LoopNest(
                tuple(Loop(*lp) for lp in loops), design.arch.num_levels),
                check_capacity=cfg.check_capacity)
            want = reference.evaluate(li, loops)
            assert bool(got.result.valid) == want[0]
            valid += want[0]
            if want[0]:
                for g, w in zip((got.cycles, got.energy_pj, got.edp), want[1:]):
                    assert abs(g - w) <= 1e-12 * abs(w)
    assert valid > 0


@pytest.mark.parametrize("name", CONFIGS + ("stc",))
def test_batched_engine_within_the_limit(name, request):
    """The bucket arrays the benchmark hands the engine mean the
    mappings the reference evaluates: the CPU engine's rows agree."""
    from repro_torch.core import Sparseloop
    from repro_torch.core.batched import TemplateBucket
    cfg = _config(name, request)
    design = cfg.program_design()
    reference = judge.Reference(cfg)
    rows = []
    for li, layer in enumerate(cfg.layers):
        ms = _mappings(cfg, layer, 64, 200 + li)
        t, s = mappings.bucket_shape(ms)
        bm = Sparseloop(design, device="cpu").bucketed_model(
            cfg.program_workload(layer),
            TemplateBucket(ranks=ms.ranks, temporal_slots=t, spatial_slots=s))
        res = bm.evaluate(*mappings.bucket_arrays(ms))
        rows += [judge.Row(f"{li}.{c}", li, tuple(mappings.loops(ms, c)), {
            "engine": (bool(res["valid"][c]), res["cycles"][c],
                       res["energy_pj"][c], res["edp"][c])})
            for c in range(len(ms))]
    read = judge.readings(rows, cfg, reference=reference)
    assert read["valid_mismatch"] == 0 and read["illegal"] == 0
    assert read["metric_gap"] < judge.LIMITS["metric_gap"]
    # fewer of the drawn tilings fit STC's 2,048-word RF
    share = 16 if name == "stc" else 4
    assert sum(r.claims["engine"][0] for r in rows) > len(rows) // share


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.'); import portbench.reference, "
            "portbench.reference.presets; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'torch'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_float32_control_is_float32():
    cfg = Config.load("scnn-resnet50")
    low = judge.Reference(cfg, precision=np.float32)
    ms = _mappings(cfg, cfg.layers[0], 16, 7)
    seen = False
    for c in range(len(ms)):
        design = low.design
        nest = ref.LoopNest(tuple(ref.Loop(*lp) for lp in mappings.loops(ms, c)),
                            design.arch.num_levels)
        with ref.computed_in(np.float32):
            ev = low.model.evaluate(low.workloads[0], nest)
        if ev.result.valid:
            assert isinstance(ev.result.edp, np.float32)
            assert isinstance(design.arch.levels[0].read_energy_pj, np.float32)
            seen = True
    assert seen
