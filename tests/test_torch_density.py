"""The port's tensor density statistics against the JAX package's scalar
models.

``repro_torch.core.density``'s ``<kind>_<stat>_t`` forms, behind
``TracedDensityStats``, must reproduce the reference scalar
``prob_empty`` / ``expected_density`` / ``max_nnz`` of
``repro.core.density`` at every tile size — non-divisible tile sizes,
tiles past the tensor's end and all-zero rows included (the cases of
``tests/test_density_traced.py``) — both one tile at a time and over a
leading candidate dimension."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import density as ref  # noqa: E402
from repro_torch.core import density as port  # noqa: E402


def _pair(ref_model):
    """The port's model of the same kind and parameters."""
    name = type(ref_model).__name__
    if name == "ActualDataModel":
        return port.ActualDataModel(data=ref_model.data)
    if name == "BandedModel":
        return port.BandedModel(rows=ref_model.rows, cols=ref_model.cols,
                                half_band=ref_model.half_band)
    if name == "StructuredModel":
        return port.StructuredModel(tensor_size=ref_model.tensor_size,
                                    n=ref_model.n, m=ref_model.m)
    if name == "UniformModel":
        return port.UniformModel(tensor_size=ref_model.tensor_size,
                                 density=ref_model.density)
    return port.DenseModel(tensor_size=ref_model.tensor_size)


def _check(ref_models, tile_sizes, tol=1e-9):
    models = [_pair(m) for m in ref_models]
    caps = port.caps_for_models(models)
    assert caps == port.DensityCaps(
        **vars(ref.caps_for_models(ref_models)))
    stats = port.TracedDensityStats(caps)
    tiles = torch.as_tensor(np.asarray(tile_sizes, np.float64))
    for rm, m in zip(ref_models, models):
        np.testing.assert_array_equal(m.params(), rm.params())
        np.testing.assert_array_equal(m.hist_table(), rm.hist_table())
        params = torch.as_tensor(m.params())
        hist = np.zeros((3, caps.hist))
        hist[:, : m.hist_table().shape[1]] = m.hist_table()
        hist = torch.as_tensor(hist)
        # a tensor kind id and every kind present: the torch.where path
        kind = torch.tensor(m.kind_id)
        got = {name: getattr(stats, name)(kind, params, hist, tiles)
               for name in ("prob_empty", "expected_density", "max_nnz")}
        for i, t in enumerate(tile_sizes):
            want = (rm.prob_empty(t), rm.expected_density(t),
                    rm.max_nnz(t))
            have = (float(got["prob_empty"][i]),
                    float(got["expected_density"][i]),
                    float(got["max_nnz"][i]))
            for w, h in zip(want, have):
                assert h == pytest.approx(w, rel=tol, abs=tol), \
                    (type(rm).__name__, t, want, have)
            # one tile at a time, with the kind known on the host
            one = float(stats.prob_empty(m.kind_id, params, hist,
                                         float(t), kinds=(m.kind_id,)))
            assert one == pytest.approx(want[0], rel=tol, abs=tol)


def test_actual_histogram_every_tile_size():
    rng = np.random.default_rng(0)
    a = (rng.random((7, 13)) < 0.3).astype(float)      # 91 elements
    _check([ref.ActualDataModel(data=a)], list(range(1, 92)) + [100, 1000])


def test_actual_all_zero_and_single_dense_row():
    _check([ref.ActualDataModel(data=np.zeros((6, 6)))],
           [1, 2, 5, 7, 36, 50])
    a = np.zeros((8, 8))
    a[0, :] = 1.0
    _check([ref.ActualDataModel(data=a)], [1, 3, 8, 9, 64])


@pytest.mark.parametrize("model", [
    ref.DenseModel(tensor_size=64),
    ref.UniformModel(tensor_size=256, density=0.3),
    ref.UniformModel(tensor_size=100, density=0.0),
    ref.StructuredModel(tensor_size=128, n=2, m=4),
    ref.StructuredModel(tensor_size=96, n=1, m=8),
    ref.BandedModel(rows=16, cols=24, half_band=2),
    ref.BandedModel(rows=9, cols=7, half_band=0),
], ids=lambda m: type(m).__name__)
def test_statistical_kinds_every_tile_size(model):
    tiles = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 25, 63, 64, 100]
    if isinstance(model, ref.BandedModel):
        # the banded divisor scan is sized by the tensor (DensityCaps.div):
        # the model answers for tiles that fit in the tensor
        tiles = [t for t in tiles if t <= model.tensor_size]
    _check([model], tiles)


def test_mixed_kinds_share_one_stats_object():
    """Caps of a mixed population keep every branch; each kind selects
    its own statistics."""
    models = [ref.UniformModel(tensor_size=256, density=0.3),
              ref.BandedModel(rows=16, cols=16, half_band=1),
              ref.ActualDataModel(data=np.eye(10))]
    _check(models, [1, 2, 4, 9, 10, 16, 33])


def test_zero_caps_prune_banded_and_actual_branches():
    stats = port.TracedDensityStats(port.DensityCaps())
    p = torch.as_tensor(port.UniformModel(64, 0.5).params())
    pe = stats.prob_empty(port.BANDED_ID, p, torch.zeros((3, 0)), 4.0)
    assert float(pe) == 0.0          # pruned to the dense form
    assert port.caps_for_models(
        [port.UniformModel(1024, 0.5)]) == port.DensityCaps()


def test_instance_wrappers_match_scalar_methods():
    rng = np.random.default_rng(3)
    data = (rng.random(48) < 0.4).astype(float)
    m = port.ActualDataModel(data=data)
    tiles = torch.tensor([1.0, 3.0, 7.0, 16.0, 48.0])
    for t, pe, mx in zip(tiles, m.prob_empty_b(tiles), m.max_nnz_b(tiles)):
        assert float(pe) == pytest.approx(m.prob_empty(int(t)))
        assert float(mx) == float(m.max_nnz(int(t)))
    b = port.BandedModel(rows=12, cols=12, half_band=1)
    for t in (2, 6, 9):
        assert float(b.max_nnz_b(float(t))) == b.max_nnz(t)
