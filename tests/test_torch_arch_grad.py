"""The port's architecture gradient (``BucketedModel.evaluate_with_arch_grad``
and ``traced_single``).

Against central finite differences of the port's copied scalar oracle
(the JAX package's own bar, ``tests/test_fused.py``): every finite
storage and compute column of the ``ArchParams`` rows, for the raw EDP
and for the smooth capacity surrogate (``log(edp)`` plus a softplus
barrier per level, computed from the oracle's per-level occupancy), to
1e-3 relative, agreeing on zero where the difference is below 1e-12 of
the loss.  Against the JAX package's ``evaluate_with_arch_grad`` on the
same bounds and rank ids (in a subprocess: jax 0.9 needs an alias to
import ``repro.core.batched``): loss and every gradient entry within
1e-6 relative, the batched parity bound.  Plus the engine's tie rule
(a tie splits the gradient in half, as ``jnp.maximum`` does) and the
device-tensor step ``traced_single``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as R  # noqa: E402
from repro_torch.core import Sparseloop  # noqa: E402
from repro_torch.core.arch import (COMPUTE_FIELDS,  # noqa: E402
                                   STORAGE_FIELDS, pack_arch_params)
from repro_torch.core.nest_program import _max, _min  # noqa: E402

CPU = "cpu"
#: the finite-difference bar and the batched parity bound
FD_REL, PARITY_REL = 1e-3, 1e-6
TAU = 0.05
CASES = R.search_cases("repro_torch")
#: (case, metric, surrogate) of the parity runs
RUNS = [("free", "edp", False), ("free", "edp", True),
        ("free", "cycles", False), ("conv2_x", "edp", False),
        ("conv2_x", "energy_pj", True), ("cosearch", "edp", True)]
POP = 8


def _inputs() -> dict:
    out = {}
    for i, name in enumerate(sorted({c for c, _, _ in RUNS})):
        enc = CASES[name][2]
        out[name + ".pop"] = R.genomes_for(enc, POP, seed=20 + i)[1]
    return out


INPUTS = _inputs()

reference = R.reference_fixture(f"""
    import torch_reference as R
    from repro.core import Sparseloop
    cases = R.search_cases("repro")
    for case, metric, surrogate in {RUNS!r}:
        design, wl, enc = cases[case]
        pop = IN[case + ".pop"]
        bucket, bounds, ids = enc.decode_bucketed(pop)
        ap = enc.arch_params_of(pop) if hasattr(enc, "arch_params_of") \\
            else None
        bm = Sparseloop(design).bucketed_model(wl, bucket)
        out = bm.evaluate_with_arch_grad(bounds, ids, arch_params=ap,
                                         metric=metric,
                                         surrogate=surrogate, tau={TAU})
        for k in ("loss", "grad_storage", "grad_compute", metric,
                  "valid"):
            OUT[f"{{case}}.{{metric}}.{{surrogate}}.{{k}}"] = \\
                np.asarray(out[k])
""", INPUTS)


def _port(case, metric, surrogate, **kw):
    design, wl, enc = CASES[case]
    pop = INPUTS[case + ".pop"]
    bucket, bounds, ids = enc.decode_bucketed(pop)
    ap = enc.arch_params_of(pop) if hasattr(enc, "arch_params_of") \
        else None
    bm = Sparseloop(design, device=CPU).bucketed_model(wl, bucket)
    return bm, bounds, ids, bm.evaluate_with_arch_grad(
        bounds, ids, arch_params=ap, metric=metric, surrogate=surrogate,
        tau=TAU, **kw)


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case,metric,surrogate", RUNS)
def test_arch_grad_matches_the_reference(reference, case, metric,
                                         surrogate):
    _, _, _, got = _port(case, metric, surrogate)
    prefix = f"{case}.{metric}.{surrogate}."
    np.testing.assert_array_equal(got["valid"], reference[prefix + "valid"])
    for k in ("loss", metric, "grad_storage", "grad_compute"):
        g, w = np.asarray(got[k], float), np.asarray(reference[prefix + k])
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=k)
        fin = np.isfinite(w)
        # entries at round-off of their row's scale are zeros
        scale = np.abs(np.where(fin, w, 0)).reshape(len(w), -1).max(1)
        atol = 1e-12 * scale.reshape((-1,) + (1,) * (w.ndim - 1))
        ok = np.abs(g - w) <= PARITY_REL * np.abs(w) + atol
        assert ok[fin].all(), (k, np.abs(g - w)[fin & ~ok][:4],
                               w[fin & ~ok][:4])


# ----------------------------------------------------------------------
# central finite differences of the scalar oracle
# ----------------------------------------------------------------------
def _perturb_storage(arch, s, j, v):
    name = arch.level(s).name
    field = STORAGE_FIELDS[j]
    levels = tuple(dataclasses.replace(lv, **{field: v})
                   if lv.name == name else lv for lv in arch.levels)
    return dataclasses.replace(arch, levels=levels)


def _perturb_compute(arch, j, v):
    field = COMPUTE_FIELDS[j]
    v = int(round(v)) if field == "instances" else v
    return dataclasses.replace(
        arch, compute=dataclasses.replace(arch.compute, **{field: v}))


def _oracle_loss(design, wl, nest, arch, surrogate: bool) -> float:
    """The scalar oracle's EDP, or its surrogate: log(EDP) plus
    softplus((occupancy - capacity) / (tau * capacity)) per finite
    level."""
    res = Sparseloop(dataclasses.replace(design, arch=arch)).evaluate(
        wl, nest, check_capacity=False).result
    if not surrogate:
        return res.edp
    loss = math.log(max(res.edp, 1e-300))
    for lv in res.levels:
        cap = lv.capacity_words
        z = ((lv.occupancy_words_max - cap) / (TAU * cap)
             if math.isfinite(cap) else -30.0)
        loss += float(np.logaddexp(z, 0.0))
    return loss


@pytest.mark.parametrize("case", ["free", "conv2_x"])
@pytest.mark.parametrize("surrogate", [False, True],
                         ids=["raw", "surrogate"])
def test_arch_grad_matches_scalar_oracle_fd(case, surrogate):
    """d(loss)/d(column) from one autograd pass matches a central finite
    difference of the scalar oracle, on every finite storage and
    compute column (plateaued columns agree on zero; under the surrogate
    the capacity column is differentiable too)."""
    design, wl, enc = CASES[case]
    _, _, _, out = _port(case, "edp", surrogate)
    S = design.arch.num_levels
    assert out["grad_storage"].shape == (POP, S, len(STORAGE_FIELDS))
    assert out["grad_compute"].shape == (POP, len(COMPUTE_FIELDS))
    c = int(np.flatnonzero(out["valid"])[0])
    nest = enc.nest_of(INPUTS[case + ".pop"][c])
    arch = design.arch
    ap = pack_arch_params(arch)
    scale = abs(float(out["loss"][c]))
    checked = 0

    def check(g, fd, what):
        if abs(fd) < 1e-12 * scale:
            assert abs(g) < 1e-9 * scale, what
        else:
            assert g == pytest.approx(fd, rel=FD_REL), what

    for s in range(S):
        for j in range(len(STORAGE_FIELDS)):
            x = float(ap.storage[s, j])
            if not np.isfinite(x):
                continue
            h = 1e-4 * max(abs(x), 1.0)
            fd = (_oracle_loss(design, wl, nest,
                               _perturb_storage(arch, s, j, x + h),
                               surrogate)
                  - _oracle_loss(design, wl, nest,
                                 _perturb_storage(arch, s, j, x - h),
                                 surrogate)) / (2 * h)
            check(float(out["grad_storage"][c, s, j]), fd,
                  f"storage {s} {STORAGE_FIELDS[j]}")
            checked += 1
    for j, field in enumerate(COMPUTE_FIELDS):
        x = float(ap.compute[j])
        h = 1.0 if field == "instances" else 1e-4 * max(abs(x), 1.0)
        fd = (_oracle_loss(design, wl, nest, _perturb_compute(arch, j, x + h),
                           surrogate)
              - _oracle_loss(design, wl, nest,
                             _perturb_compute(arch, j, x - h),
                             surrogate)) / (2 * h)
        check(float(out["grad_compute"][c, j]), fd, f"compute {field}")
        checked += 1
    assert checked >= S * len(STORAGE_FIELDS) - S + len(COMPUTE_FIELDS)
    if surrogate:
        cap = STORAGE_FIELDS.index("capacity_words")
        finite = np.isfinite(ap.storage[:, cap])
        assert np.abs(out["grad_storage"][c, finite, cap]).max() > 0


# ----------------------------------------------------------------------
# the engine's tie rule and the device-tensor step
# ----------------------------------------------------------------------
def test_ties_split_the_gradient_as_the_reference():
    """At a tie ``jnp.maximum`` / ``jnp.minimum`` pass half the
    gradient to each side; the engine's helpers do the same against a
    Python float (``torch.clamp`` would pass all of it), and still use
    one clamp off the gradient path."""
    for fn, x in ((_max, [1.0, 2.0, 0.5]), (_min, [1.0, 0.5, 2.0])):
        a = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        fn(a, 1.0).sum().backward()
        np.testing.assert_array_equal(a.grad.numpy(), [0.5, 1.0, 0.0])
        a.grad = None
        fn(1.0, a).sum().backward()
        np.testing.assert_array_equal(a.grad.numpy(), [0.5, 1.0, 0.0])
        b = torch.tensor(x, dtype=torch.float64)
        assert torch.equal(fn(b, 1.0), fn(b, torch.ones(3,
                                                        dtype=b.dtype)))


def test_traced_single_is_the_evaluate_step_on_device_tensors():
    design, wl, enc = CASES["free"]
    pop = INPUTS["free.pop"]
    bucket, bounds, ids = enc.decode_bucketed(pop)
    bm = Sparseloop(design, device=CPU).bucketed_model(wl, bucket)
    want = bm.evaluate(bounds, ids)
    storage, comp = pack_arch_params(design.arch).leaves()
    rows = (torch.as_tensor(storage).expand(POP, *storage.shape),
            torch.as_tensor(comp).expand(POP, *comp.shape))
    got = bm.traced_single(torch.as_tensor(bounds, dtype=torch.float64),
                           torch.as_tensor(ids), bm._bind_params(None),
                           rows)
    for k in ("cycles", "energy_pj", "edp", "valid", "occupancy"):
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # the gradient path leaves the cached rows alone
    before = [t.clone() for t in
              bm._upload([bounds, ids], bm.arch_params, POP)[1]]
    bm.evaluate_with_arch_grad(bounds, ids, surrogate=True)
    after = bm._upload([bounds, ids], bm.arch_params, POP)[1]
    for x, y in zip(before, after):
        assert not y.requires_grad and torch.equal(x, y)
