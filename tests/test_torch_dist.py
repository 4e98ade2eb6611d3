"""The port's distribution layer against the JAX package's.

* Specs: every parameter's partition spec equals the reference's spec of
  its leaf (the leading layer axis of its stacked groups dropped), for
  all ten configurations, full and reduced; ``resolve_spec``,
  ``batch_spec`` and ``zero1_specs`` equal the reference's on the
  (16, 16) and (2, 16, 16) meshes (the reference's functions take a
  duck-typed mesh: they read ``.shape`` and ``.axis_names`` only).
* ``input_specs`` builds every family's cells on a fake (2, 2) mesh
  under all three policies, placed as the specs say, with nothing
  allocated; ``elastic_mesh`` and ``make_debug_mesh`` give (1, 1) on a
  one-rank gloo group.
* Sharding is right, not only coherent: on 2 gloo ranks, reduced
  qwen2-0.5b in f32 takes its loss, gradients and one train step with
  the model placed by its specs on a (1, 2) and a (2, 1) mesh, within
  1e-5 of the unsharded port; a checkpoint saved unsharded restores onto
  the mesh.  On a fake (2, 2) mesh a column-then-row MLP's collective
  bytes equal the hand count.
* The dry run: a cut qwen2 cell is ``ok`` with per-rank counts whose
  product with the ranks covers the world-1 count, ``long_500k`` skips
  for a full-attention arch, records go to ``results/dryrun_torch``;
  the roofline reads them with the H100's datasheet peaks.
"""
import dataclasses
import json
import multiprocessing as mp
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch.steps import abstract_params as ref_abstract_params  # noqa: E402
from repro.optim import zero1_specs as ref_zero1_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.costanalysis import CostMode, analyze  # noqa: E402
from repro_torch.launch.mesh import fake_world, production_mesh_shape  # noqa: E402
from repro_torch.launch.sharding import (P, ShardedExecution,  # noqa: E402
                                         batch_spec, named_sharding,
                                         resolve_spec, shard_tree)
from repro_torch.models import get_api, param_specs  # noqa: E402
from repro_torch.optim import zero1_specs  # noqa: E402


class DuckMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, multi_pod):
        axes = production_mesh_shape(multi_pod=multi_pod)
        self.axis_names = tuple(a for a, _ in axes)
        self.shape = dict(axes)


def _ref_flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _ref_flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _ref_specs_by_port_key(arch, reduced, model):
    """{port state-dict key: (reference spec without the layer axis,
    reference per-layer shape)}."""
    shapes, specs = ref_abstract_params(ref_get_config(arch, reduced=reduced))
    flat_shapes = dict(_ref_flat(shapes))
    out = {}
    for key, spec in _ref_flat(specs):
        group = key.split(".", 1)[0]
        entries, shape = tuple(spec), tuple(flat_shapes[key].shape)
        if isinstance(model[group], torch.nn.ModuleList):
            assert entries[0] is None, key
            for layer in range(len(model[group])):
                out[f"{group}.{layer}.{key[len(group) + 1:]}"] = (
                    entries[1:], shape[1:])
        else:
            out[key] = (entries, shape)
    return out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    model, specs = steps.abstract_params(cfg)
    assert specs == param_specs(model)
    want = _ref_specs_by_port_key(arch, reduced, model)
    assert specs.keys() == want.keys()
    for key, spec in specs.items():
        assert isinstance(spec, P)
        assert tuple(spec) == want[key][0], key


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_resolve_batch_and_zero1_specs_equal_reference(multi_pod):
    mesh = DuckMesh(multi_pod)
    for arch in ("qwen2-0.5b", "deepseek-v2-lite-16b", "xlstm-350m",
                 "zamba2-7b", "whisper-base", "internvl2-76b"):
        cfg = get_config(arch)
        model, specs = steps.abstract_params(cfg)
        want = _ref_specs_by_port_key(arch, False, model)
        shapes = dict(model.named_parameters())
        z1 = zero1_specs(specs, shapes, data_size=16)
        for key, spec in specs.items():
            shape = tuple(shapes[key].shape)
            got = resolve_spec(spec, shape, mesh)
            ref = ref_sharding.resolve_spec(JP(*want[key][0]), shape, mesh)
            assert tuple(got) == tuple(ref), (arch, key)
            ref_z = ref_zero1_specs({"x": JP(*want[key][0])},
                                    {"x": jax.ShapeDtypeStruct(shape,
                                                               "float32")},
                                    data_size=16)["x"]
            assert tuple(z1[key]) == tuple(ref_z), (arch, key)
            assert tuple(resolve_spec(z1[key], shape, mesh)) == tuple(
                ref_sharding.resolve_spec(ref_z, shape, mesh))
    for b in (1, 2, 8, 16, 24, 32, 128, 256, 512):
        assert tuple(batch_spec(mesh, b)) == tuple(
            ref_sharding.batch_spec(mesh, b)), b
    assert resolve_spec(None, (4,), mesh) == P()


def test_named_sharding_places_specs_by_mesh_dim():
    """Single pod: one placement per mesh axis.  Multi-pod: placements on
    the (pod x data, model) view, where a dimension the reference splits
    over "data" alone is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    single, multi = DuckMesh(False), DuckMesh(True)
    assert named_sharding(P("data", "model"), (64, 32), single) == (
        Shard(0), Shard(1))
    assert named_sharding(P("data", "model"), (64, 32), multi) == (
        Shard(0), Shard(1))
    assert named_sharding(P("data"), (16, 3), single) == (
        Shard(0), Replicate())
    assert named_sharding(P("data"), (16, 3), multi) == (
        Replicate(), Replicate())                  # 16 % 32: just "data"
    assert named_sharding(P(None, "model"), (4, 6), multi) == (
        Replicate(),) * 2                           # 6 % 16: replicated
    assert named_sharding(P(("pod", "data", "model")), (512,), multi) == (
        Shard(0), Shard(0))
    with fake_world(512):
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.sharding import placement_mesh
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        view = placement_mesh(mesh)
        assert view.mesh_dim_names == ("data", "model")
        assert tuple(view.shape) == (32, 16)
        assert view.mesh.flatten().tolist() == mesh.mesh.flatten().tolist()
        assert placement_mesh(mesh) is view


# ----------------------------------------------------------------------
# input_specs on a fake (2, 2) mesh, every family
# ----------------------------------------------------------------------
def _mesh22():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _dtensors(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, DTensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _dtensors(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _dtensors(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _dtensors(v)]
    return []


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-scout-17b-a16e",
                                  "deepseek-v2-lite-16b", "xlstm-350m",
                                  "zamba2-7b", "internvl2-76b",
                                  "whisper-base"])
def test_input_specs_build_on_fake_mesh(arch):
    from torch.distributed.tensor import DTensor, Shard
    cfg = get_config(arch, reduced=True)
    with fake_world(4):
        mesh = _mesh22()
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            spec = dataclasses.replace(steps.SHAPES[shape], seq=512, batch=4)
            for policy in steps.POLICIES:
                got = steps.input_specs(cfg, spec, mesh, policy)
                want = {"train": {"params", "batch", "opt_state"},
                        "prefill": {"params", "batch"},
                        "decode": {"params", "batch", "cache", "pos"}}
                assert set(got) == want[spec.kind]
                leaves = _dtensors({k: v for k, v in got.items()
                                    if k != "pos"})
                assert leaves and all(isinstance(t, DTensor)
                                      for t in leaves)
                assert all(t.to_local().device.type == "meta"
                           for t in leaves)
                _, specs = steps.abstract_params(cfg)
                for name, p in got["params"].named_parameters():
                    want_spec = specs[name]
                    if policy == "dp_only":
                        want_spec = P(*[None if e == "model" else e
                                        for e in want_spec])
                    assert tuple(p.placements) == named_sharding(
                        want_spec, tuple(p.shape), mesh), name
                tok = next(iter(got["batch"].values()))
                assert isinstance(tok.placements[0], Shard)
                if policy == "dp_only":   # the batch over every axis
                    assert tok.placements == (Shard(0), Shard(0))
                if spec.kind == "train":
                    mu = got["opt_state"].mu
                    assert any(p.placements != mu[n].placements
                               for n, p in got["params"].named_parameters())
        with pytest.raises(ValueError, match="policy"):
            steps.input_specs(cfg, steps.SHAPES["train_4k"], mesh, "pp")


def _one_rank_gloo():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def test_elastic_and_debug_mesh_one_rank():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import elastic_mesh
    _one_rank_gloo()
    try:
        for mesh in (elastic_mesh(device_type="cpu"),
                     elastic_mesh(prefer_model=1, device_type="cpu"),
                     make_debug_mesh(device_type="cpu")):
            assert mesh.mesh_dim_names == ("data", "model")
            assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()
    with fake_world(8):
        assert tuple(make_debug_mesh(device_type="cpu").shape) == (2, 4)
        assert tuple(elastic_mesh(prefer_model=3,
                                  device_type="cpu").shape) == (4, 2)
    with pytest.raises(RuntimeError, match="already"):
        _one_rank_gloo()
        try:
            with fake_world(2):
                pass
        finally:
            dist.destroy_process_group()


def test_mlp_collective_bytes_equal_hand_count():
    """x (B, d) split over data @ W1 (d, f) split by columns over model,
    then @ W2 (f, d) split by rows: the second product leaves each rank
    a partial (B/2, d) that one all-reduce over the model axis sums."""
    from torch.distributed.tensor import Replicate
    B, d, f = 8, 16, 32
    with fake_world(4):
        mesh = _mesh22()
        x = shard_tree(torch.empty(B, d, device="meta"), P("data"), mesh)
        w1 = shard_tree(torch.empty(d, f, device="meta"), P(None, "model"),
                        mesh)
        w2 = shard_tree(torch.empty(f, d, device="meta"), P("model", None),
                        mesh)
        with CostMode() as cm, ShardedExecution():
            y = torch.relu(x @ w1) @ w2
            y = y.redistribute(mesh, (y.placements[0], Replicate()))
    costs = cm.costs
    assert costs.collective_count == 1
    assert costs.collective_bytes["all-reduce"] == (B // 2) * d * 4
    assert costs.total_collective_bytes == (B // 2) * d * 4
    # per rank: (B/2 x d) @ (d x f/2) and (B/2 x f/2) @ (f/2 x d)
    assert costs.dot_flops == 2 * (B // 2) * d * (f // 2) * 2
    assert tuple(y.to_local().shape) == (B // 2, d)


# ----------------------------------------------------------------------
# 2 gloo ranks: sharded training equals the unsharded port
# ----------------------------------------------------------------------
def _rank_main(rank, port_dir, mesh_shape, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{port_dir}/store",
                            rank=rank, world_size=2)
    try:
        from repro_torch.checkpoint import load_checkpoint, save_checkpoint
        from repro_torch.launch.sharding import sharding_tree
        from repro_torch.optim import adamw_init
        cfg = get_config("qwen2-0.5b", reduced=True)
        api = get_api(cfg)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32))
            for k in ("tokens", "targets")}

        def build():
            return api.init(cfg, torch.Generator().manual_seed(0), "cpu")

        plain = build()
        specs = param_specs(plain)
        loss_fn = steps.make_loss_fn(cfg)
        plain.requires_grad_(True)
        want_loss = loss_fn(plain, batch)
        want_loss.backward()
        want = {n: p.grad.clone() for n, p in plain.named_parameters()}

        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        model = shard_tree(build(), specs, mesh)
        sb = shard_tree(batch, {k: batch_spec(mesh, 4) for k in batch},
                        mesh)
        model.requires_grad_(True)
        with ShardedExecution():
            loss = loss_fn(model, sb)
            loss.backward()
        err = {"loss": abs(float(loss.detach().full_tensor())
                           - float(want_loss))}
        err["grad"] = max(float((p.grad.full_tensor() - want[n]).abs().max())
                          for n, p in model.named_parameters())
        # one train step, sharded vs plain
        model2 = shard_tree(build(), specs, mesh)
        opt2 = adamw_init(model2, mesh, specs)
        plain2 = build()
        opt_p = adamw_init(plain2)
        step = steps.make_train_step(cfg, lr=1e-3)
        _, _, m_p = step(plain2, opt_p, batch)
        with ShardedExecution():
            _, _, m_s = step(model2, opt2, sb)
        err["step_loss"] = abs(float(m_s["loss"].full_tensor())
                               - float(m_p["loss"]))
        err["gnorm"] = abs(float(m_s["grad_norm"].full_tensor())
                           - float(m_p["grad_norm"]))
        ref_params = dict(plain2.named_parameters())
        err["param"] = max(float((p.full_tensor() - ref_params[n]).abs()
                                 .max())
                           for n, p in model2.named_parameters())
        err["mu_split"] = any(opt2.mu[n].placements != p.placements
                              for n, p in model2.named_parameters())
        # a checkpoint saved unsharded restores onto the mesh
        ck = pathlib.Path(port_dir) / "ck"
        if rank == 0:
            save_checkpoint(ck, 1, {"params": plain2})
        dist.barrier()
        skel, _ = steps.abstract_params(cfg)
        got, _ = load_checkpoint(ck, {"params": skel}, device="cpu",
                                 shardings={"params": sharding_tree(
                                     skel, specs, mesh)}, mesh=mesh)
        err["restore"] = max(
            float((p.full_tensor() - ref_params[n]).abs().max())
            for n, p in got["params"].named_parameters())
        err["restored_dtensor"] = all(hasattr(p, "placements")
                                      for p in got["params"].parameters())
        if rank == 0:
            (pathlib.Path(port_dir) / out).write_text(json.dumps(err))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1)])
def test_sharded_training_equals_unsharded(mesh_shape, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path), mesh_shape, "err.json"))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    err = json.loads((tmp_path / "err.json").read_text())
    assert err["loss"] <= 1e-5 and err["step_loss"] <= 1e-5, err
    assert err["grad"] <= 1e-5 and err["gnorm"] <= 1e-5, err
    # AdamW's first step moves each weight by about lr (1e-3) whatever its
    # gradient's size, so a gradient a few 1e-8 from 0 can move by a few
    # hundredths of lr more or less
    assert err["param"] <= 5e-5, err
    assert err["restore"] == 0.0 and err["restored_dtensor"], err
    assert err["mu_split"] == (mesh_shape == (2, 1)), err


# ----------------------------------------------------------------------
# The dry run and the roofline
# ----------------------------------------------------------------------
def test_dryrun_cell_ok_and_counts_cover_world1(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun, roofline
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path / "dryrun_torch")
    cut = {"num_layers": 1}
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", "single",
                          verbose=False, cfg_overrides=cut)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["ranks"] == 256 and rec["world1_dot_flops"] > 0
    assert rec["dot_flops"] * rec["ranks"] >= rec["world1_dot_flops"]
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["collectives"]["count"] > 0
    skipped = dryrun.run_cell("qwen2-0.5b", "long_500k", "multi",
                              verbose=False)
    assert skipped["status"] == "skipped"
    path = dryrun.save(rec)
    assert path.parent == tmp_path / "dryrun_torch"
    assert dryrun.RESULTS.name == "dryrun_torch"
    bad = dryrun.run_cell("qwen2-0.5b", "train_4k", "single",
                          verbose=False, cfg_overrides={"num_layers": 1},
                          policy="pp")
    assert bad["status"] == "error" and "policy" in bad["error"]
    # the roofline reads the records with the datasheet peaks
    dryrun.save(skipped)
    rows = roofline.build_table("single", tmp_path / "dryrun_torch")
    r = next(r for r in rows if "compute_s" in r)
    assert r["compute_s"] == rec["dot_flops"] / roofline.PEAK_FLOPS
    assert r["memory_s"] == rec["dot_bytes"] / roofline.HBM_BW
    assert r["step_lower_bound_s"] == max(r["compute_s"], r["memory_s"],
                                          r["collective_s"])
    assert roofline.main(["--results", str(tmp_path / "dryrun_torch"),
                          "--peak-flops", "1e15"])[0]["compute_s"] == \
        rec["dot_flops"] / 1e15
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9 and roofline.PEAK_FLOPS_F32 == 67e12


def test_flash_attention_operator_counts_its_formula():
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.ops import flash_attention_flops
    q = torch.empty(2, 256, 4, 64, device="meta")
    k = torch.empty(2, 256, 2, 64, device="meta")
    for causal in (True, False):
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.flash_attention(q, k, k, causal)
        assert out.shape == q.shape and out.dtype == torch.float32
        want = flash_attention_flops(2, 256, 4, 64, causal)
        assert fc.get_total_flops() == want
        _, costs = analyze(torch.ops.repro_torch.flash_attention, q, k, k,
                           causal)
        assert costs.dot_flops == want
        assert costs.by_op["flash_attention"][0] == want
    assert flash_attention_flops(1, 4, 1, 1, True) == 4 * 10


def test_train_cli_compress_grads_on_one_rank():
    """``--compress-grads`` sums the data-parallel gradients with the
    int8 all-reduce: on a one-rank (1, 1) mesh the first loss is the
    uncompressed run's and the next ones move by quantization noise
    only; without a mesh the step refuses."""
    from repro_torch.launch.train import main
    args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "32"]
    plain = main(args)["losses"]
    comp = main(args + ["--compress-grads"])["losses"]
    assert comp[0] == plain[0]
    assert all(abs(a - b) < 2e-2 for a, b in zip(comp, plain)), (comp, plain)
    assert comp != plain
    with pytest.raises(ValueError, match="mesh"):
        steps.make_train_step(get_config("qwen2-0.5b", reduced=True),
                              compress_grads=True)
