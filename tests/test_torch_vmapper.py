"""The port's vectorized mapper preset (``repro_torch.core.vmapper``)
against the JAX package's (``repro.core.vmapper``, run in a subprocess:
under jax 0.9 it imports only with an alias) and against the JAX
package's scalar oracle (in process), on the parity cases of
``tests/test_vmapper.py``: dense, coordinate-list and bitmask designs
of a 16x16x16 spMspM, every (m1, m0, n1, ns, n0) tiling.  Held to 1e-6
relative; the port runs on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as R  # noqa: E402
from repro.core import Sparseloop as RefSparseloop  # noqa: E402
from repro.core import matmul as ref_matmul  # noqa: E402
from repro.core import nest as ref_nest  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro_torch.core.presets import two_level_arch  # noqa: E402
from repro_torch.core.vmapper import (SPMSPM_TEMPLATE, VDesign,  # noqa: E402
                                      candidate_factors, evaluate_batch,
                                      search)

M = N = K = 16
DA, DB = 0.25, 0.5
CPU = "cpu"
#: name -> (VDesign fields, the preset the scalar oracle runs)
CASES = {
    "dense": ({}, "dense_design"),
    "coordlist": (dict(compress=True, meta_bits_per_nnz=32, skip=True,
                       gate=True), "coordinate_list_design"),
    "bitmask": (dict(compress=True, meta_bits_per_coord=2.0, gate=True),
                "bitmask_design"),
}

reference = R.reference_fixture(f"""
    from repro.core.presets import two_level_arch
    from repro.core.vmapper import (VDesign, candidate_factors,
                                    evaluate_batch, search)
    arch = two_level_arch(buffer_kwords=64)
    OUT["factors"] = candidate_factors({M}, {N}, {K})
    for name, (kw, _) in {CASES!r}.items():
        vd = VDesign(**kw)
        out = evaluate_batch(OUT["factors"], {M}, {N}, {K}, {DA}, {DB},
                             arch, vd)
        for k, v in out.items():
            OUT[f"{{name}}.{{k}}"] = np.asarray(v)
        best, metrics, n = search({M}, {N}, {K}, {DA}, {DB}, arch, vd)
        OUT[f"{{name}}.search.best"] = np.asarray(best)
        OUT[f"{{name}}.search.metrics"] = metrics
        OUT[f"{{name}}.search.n"] = n
""")


def _oracle(maker: str, m1, m0, n1, ns, n0):
    """The JAX package's scalar engine on the equivalent Design."""
    wl = ref_matmul(M, K, N, densities={"A": ("uniform", DA),
                                        "B": ("uniform", DB)})
    loops = []
    if m1 > 1:
        loops.append(("m", int(m1), 1))
    if n1 > 1:
        loops.append(("n", int(n1), 1))
    if ns > 1:
        loops.append(("n", int(ns), 1, "spatial"))
    if n0 > 1:
        loops.append(("n", int(n0), 0))
    loops.append(("k", K, 0))
    if m0 > 1:
        loops.append(("m", int(m0), 0))
    design = getattr(ref_presets, maker)(
        ref_presets.two_level_arch(buffer_kwords=64))
    return RefSparseloop(design).evaluate(wl, ref_nest(2, *loops),
                                          check_capacity=False).result


def test_candidate_factors_match_reference(reference):
    np.testing.assert_array_equal(candidate_factors(M, N, K),
                                  reference["factors"])
    assert SPMSPM_TEMPLATE.num_slots == 6


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_batch_matches_reference(reference, name):
    kw, _ = CASES[name]
    got = evaluate_batch(reference["factors"], M, N, K, DA, DB,
                         two_level_arch(buffer_kwords=64), VDesign(**kw),
                         device=CPU)
    keys = {k.split(".", 1)[1] for k in reference
            if k.startswith(name + ".") and ".search." not in k}
    assert set(got) == keys
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], reference[f"{name}.{k}"],
                                   rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_batch_matches_scalar_oracle(name):
    kw, maker = CASES[name]
    cand = candidate_factors(M, N, K)
    got = evaluate_batch(cand, M, N, K, DA, DB,
                         two_level_arch(buffer_kwords=64), VDesign(**kw),
                         device=CPU)
    want = [_oracle(maker, *c) for c in cand]
    for k in ("cycles", "energy_pj", "edp"):
        np.testing.assert_allclose(
            got[k], [getattr(r, k) for r in want], rtol=1e-6, atol=0,
            err_msg=k)
    # the engine's best ranks first
    edp = np.asarray([r.edp for r in want])
    assert edp[int(np.argmin(got["edp"]))] == edp.min()


@pytest.mark.parametrize("name", list(CASES))
def test_search_matches_reference(reference, name):
    kw, _ = CASES[name]
    best, metrics, n = search(M, N, K, DA, DB,
                              two_level_arch(buffer_kwords=64),
                              VDesign(**kw), device=CPU)
    np.testing.assert_array_equal(best, reference[f"{name}.search.best"])
    assert n == reference[f"{name}.search.n"]
    want = reference[f"{name}.search.metrics"]
    assert set(metrics) == set(want)
    for k, v in want.items():
        assert metrics[k] == pytest.approx(v, rel=1e-6), k


def test_vmapper_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluate_batch(candidate_factors(M, N, K), M, N, K, DA, DB,
                       two_level_arch(), VDesign())
