"""``runtime.compressed_grad_allreduce`` against the JAX package's.

* Given the reference's own noise (``jax.random.uniform`` of its key),
  the port's quantizer gives the reference's int8 payload and scale
  exactly.
* The reference's ``test_compressed_allreduce_small_error_and_unbiased``
  contracts on a one-rank gloo mesh: each leaf within amax/127 x 1.01,
  the bias over 30 generators below 0.2 quanta.
* On 2 gloo ranks whose leaves share one scale the result is the mean of
  the ranks' dequantized leaves within one quantum; with any scales it
  is the reference's formula (the int32 sum of the payloads times the
  mean of the scales, over the ranks).
"""
import json
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime.compression import _quantize as ref_quantize  # noqa: E402
from repro_torch.runtime import compressed_grad_allreduce  # noqa: E402
from repro_torch.runtime.compression import quantize  # noqa: E402


@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0), ((64,), 1e-3),
                                         ((3, 5, 7), 40.0), ((8,), 0.0)])
def test_quantize_equals_reference_given_its_noise(shape, scale):
    rng = np.random.default_rng(3)
    g = (scale * rng.normal(size=shape)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        q_ref, s_ref = ref_quantize(jnp.asarray(g), key)
        noise = jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5)
        q, s = quantize(torch.from_numpy(g),
                        torch.from_numpy(np.asarray(noise)))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(q_ref))
        assert float(s) == float(s_ref)


def _mesh_one_rank():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def test_compressed_allreduce_small_error_and_unbiased():
    import torch.distributed as dist
    mesh = _mesh_one_rank()
    try:
        rng = np.random.default_rng(0)
        grads = {"w": torch.from_numpy(rng.normal(size=(64, 64))
                                       .astype(np.float32)),
                 "b": torch.from_numpy(rng.normal(size=(64,))
                                       .astype(np.float32))}
        out = compressed_grad_allreduce(
            grads, mesh, generator=torch.Generator().manual_seed(1))
        # one rank: an identity up to int8 quantization; stochastic
        # rounding moves up to one full step
        for k in grads:
            step = float(grads[k].abs().max()) / 127.0
            assert out[k].dtype == grads[k].dtype
            assert float((out[k] - grads[k]).abs().max()) <= step * 1.01
        # unbiased: the mean over generators converges to the gradient
        acc = torch.zeros(64, 64, dtype=torch.float64)
        n = 30
        for i in range(n):
            o = compressed_grad_allreduce(
                {"w": grads["w"]}, mesh,
                generator=torch.Generator().manual_seed(i))
            acc += o["w"].double() / n
        bias = float((acc - grads["w"].double()).abs().mean())
        assert bias < float(grads["w"].abs().max()) / 127.0 * 0.2
        # a bf16 leaf comes back in bf16; the tree's structure is kept
        tree = [grads["b"].bfloat16(), (grads["w"][:2],)]
        got = compressed_grad_allreduce(tree, mesh)
        assert got[0].dtype == torch.bfloat16 and isinstance(got[1], tuple)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, tmp, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2, 1),
                                mesh_dim_names=("data", "model"))
        res = {}
        for case, factor in (("same_amax", 1.0), ("scaled", 3.0)):
            grads = [torch.from_numpy(np.random.default_rng(r).normal(
                size=(32, 16)).astype(np.float32)) for r in range(2)]
            for r, g in enumerate(grads):
                g[0, 0] = 6.0                   # one amax on both ranks
                g *= factor ** r
            got = compressed_grad_allreduce(
                {"g": grads[rank]}, mesh,
                generator=torch.Generator().manual_seed(5))["g"]
            # each rank's payload and scale, from its own noise
            qs = [quantize(g, torch.rand(g.shape, generator=torch.Generator()
                                         .manual_seed(5)) - 0.5)
                  for g in grads]
            deq = sum(q.float() * s for q, s in qs) / 2
            # the reference's formula: the int sum times the mean scale
            ref = sum(q.int() for q, _ in qs).float() * (
                sum(s for _, s in qs) / 2) / 2
            res[case] = {
                "err_mean": float((got - deq).abs().max()),
                "err_formula": float((got - ref).abs().max()),
                "quantum": max(float(s) for _, s in qs)}
        if rank == 0:
            (tmp / out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def test_two_ranks_give_the_mean_of_dequantized_leaves(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp_path, "c.json"))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    res = json.loads((tmp_path / "c.json").read_text())
    # ranks of one scale: the mean of their dequantized leaves
    same = res["same_amax"]
    assert same["err_mean"] <= same["quantum"], res
    # any scales: the reference's int32 sum times the mean scale
    for case in res.values():
        assert case["err_formula"] <= 1e-6 * 127 * case["quantum"], res
