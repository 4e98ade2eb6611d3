"""The port's search strategies converge as the JAX package's do.

The Table-5 cell (ResNet50 conv2_x, the SCNN-like three-level design,
spatial n = 8, budget 512, population 32): for each strategy, the best
EDP over seeds 0-19 as a ratio to enumeration at budget 5120, in both
packages (the JAX package in a subprocess).  The random streams differ
(``torch.Generator`` against ``jax.random``), so the two samples are
held to one distribution: they must not differ by a two-sample
Kolmogorov-Smirnov test at ``KS_ALPHA`` = 0.01.  Twenty seeds detect
only a large shift (about half the spread of the ratios); the
per-draw tests of ``tests/test_torch_strategies.py`` carry the power.
``chip_smoke.py`` holds the card's ES ratios to the reference's the
same way, from a recorded copy checked here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

import torch_reference as R  # noqa: E402

#: level of each strategy's two-sample test over seeds
KS_ALPHA = 0.01

reference = R.reference_fixture("""
    import torch_reference as R
    OUT.update(R.convergence_ratios("repro"))
""")


@pytest.fixture(scope="module")
def port_convergence():
    return R.convergence_ratios("repro_torch")


@pytest.mark.parametrize("strategy", R.STRATEGY_NAMES)
def test_convergence_over_seeds_as_the_reference(reference,
                                                 port_convergence,
                                                 strategy):
    """The Table-5 cell: the best EDP at budget 512 over seeds 0-19, as
    a ratio to enumeration at 5120, is drawn from the reference's
    distribution (two-sample KS at ``KS_ALPHA``)."""
    assert port_convergence["enum5120_edp"] == pytest.approx(
        reference["enum5120_edp"], rel=1e-9)
    got = np.asarray(port_convergence[strategy])
    want = np.asarray(reference[strategy])
    assert len(got) == len(want) == R.SEEDS
    assert np.isfinite(got).all() and (got > 0).all()
    p = stats.ks_2samp(got, want).pvalue
    assert p >= KS_ALPHA, (f"{strategy}: KS p = {p:.3g}; port median "
                           f"{np.median(got):.4f}, reference "
                           f"{np.median(want):.4f}")


def test_card_bar_is_the_reference_as_recorded(reference):
    """``chip_smoke.py`` holds the card's ES ratios to the JAX
    package's over the same seeds at the same level; the card runs no
    JAX, so it carries them as a constant, which must be what the
    reference computes."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_constants", os.path.join(R.ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SEARCH_SEEDS == tuple(range(R.SEEDS))
    assert (smoke.SEARCH_BUDGET, smoke.SEARCH_POP) == (512, 32)
    assert smoke.SEARCH_KS_ALPHA == KS_ALPHA
    assert list(smoke.REFERENCE_ES_RATIOS) == pytest.approx(
        list(reference["es"]), rel=1e-9)
