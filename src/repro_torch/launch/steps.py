"""Step builders: abstract shapes, shardings and step functions for
training, prefill and decode (the JAX package's ``launch/steps.py``),
shared by ``dryrun.py``, ``train.py`` and the chip smoke test.

The abstract inputs live on the ``meta`` device: even the 76B-parameter
configurations are described without allocating a byte.
:func:`input_specs` places them on a mesh as DTensors whose local shards
are on the meta device; the step functions run on them unchanged inside
``sharding.ShardedExecution``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import ModelConfig, get_api, lm_loss_from_hidden, param_specs
from ..models import transformer as T
from ..optim import adamw_init, adamw_update
from .mesh import axis_names
from .sharding import PartitionSpec as P
from .sharding import shard_tree

# ----------------------------------------------------------------------
# The assigned input-shape set (one per cell kind)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

#: number of stub patch-embedding positions prepended for the VLM arch
VLM_PATCHES = 256

_META = torch.device("meta")


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §Arch-applic.)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k-token decode KV/attention "
                       "is quadratic-cost — skipped per assignment note")
    return True, ""


# ----------------------------------------------------------------------
# Abstract params / cache / batch on the meta device
# ----------------------------------------------------------------------
def abstract_params(cfg: ModelConfig):
    """(the model of ``cfg`` on the meta device, {state-dict name:
    partition spec}): every parameter's shape and dtype, nothing
    allocated."""
    model = get_api(cfg).init(cfg, None, _META)
    return model, param_specs(model)


def abstract_cache(cfg: ModelConfig, B: int, S: int):
    """Cache/state tensors on the meta device + their spec tree, for
    decode."""
    dtype = getattr(torch, cfg.dtype)
    specs = T.cache_specs(cfg)
    if cfg.enc_dec:
        def kv(s):
            return torch.empty((cfg.num_layers, B, s, cfg.num_kv_heads,
                                cfg.head_dim), dtype=dtype, device=_META)
        return ((kv(cfg.dec_max_len), kv(cfg.dec_max_len)),
                (kv(S), kv(S))), specs
    if cfg.family == "ssm":
        return T.xlstm_init_state(cfg, B, dtype, _META), specs
    if cfg.family == "hybrid":
        return T.hybrid_init_state(cfg, B, S, dtype, _META), specs
    return T.lm_init_cache(cfg, B, S, dtype, _META), specs


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec):
    """Training/prefill/decode inputs on the meta device + their specs."""
    B, S = shape.batch, shape.seq
    dtype = getattr(torch, cfg.dtype)

    def t(*dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device=_META)

    if shape.kind == "decode":      # one token with a cache of length S
        return {"token": t(B, 1)}, {"token": P("data")}
    if cfg.enc_dec:
        batch = {"frames": t(B, S, cfg.d_model, dt=dtype),
                 "dec_tokens": t(B, cfg.dec_max_len)}
        if shape.kind == "train":
            batch["targets"] = t(B, cfg.dec_max_len)
    elif cfg.frontend == "vision_stub":
        batch = {"patches": t(B, VLM_PATCHES, cfg.d_model, dt=dtype),
                 "tokens": t(B, S - VLM_PATCHES)}
        if shape.kind == "train":
            batch["targets"] = t(B, S - VLM_PATCHES)
    else:
        batch = {"tokens": t(B, S)}
        if shape.kind == "train":
            batch["targets"] = t(B, S)
    return batch, {k: P("data") for k in batch}


# ----------------------------------------------------------------------
# Step functions
# ----------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, remat_policy: str | None = "full"):
    """``loss_fn(model, batch)``: the mean next-token cross entropy plus
    0.01 x the MoE's aux loss, an f32 scalar with autograd's graph.
    ``batch`` holds ``tokens`` and ``targets`` (vlm: also ``patches``,
    whose ``VLM_PATCHES`` positions are cut off before the loss;
    whisper: ``frames``, ``dec_tokens`` and ``targets``)."""
    api = get_api(cfg)
    kw = {}
    if not cfg.enc_dec and cfg.family in ("dense", "moe", "vlm"):
        kw["remat_policy"] = remat_policy

    def loss_fn(model, batch):
        if cfg.enc_dec:
            hidden, aux = api.forward_train(
                model, (batch["frames"], batch["dec_tokens"]), cfg)
        elif cfg.frontend == "vision_stub":
            hidden, aux = T.lm_forward_train(
                model, batch["tokens"], cfg, prefix_embeds=batch["patches"],
                **kw)
            hidden = hidden[:, VLM_PATCHES:, :]
        else:
            hidden, aux = api.forward_train(model, batch["tokens"], cfg, **kw)
        return (lm_loss_from_hidden(model, hidden, batch["targets"], cfg)
                + 0.01 * aux)

    return loss_fn


def _compressed(grads: dict, mesh, generator) -> dict:
    """The gradients still partial over the mesh's "data" dimension (a
    rank's share of the data-parallel sum) summed across it with the
    int8 all-reduce; the others as they are."""
    from torch.distributed.tensor import DTensor, Replicate
    from ..runtime import compressed_grad_allreduce
    d = mesh.mesh_dim_names.index("data")
    n = mesh.size(d)
    out = {}
    for name, g in grads.items():
        if isinstance(g, DTensor) and g.placements[d].is_partial():
            mean = compressed_grad_allreduce([g.to_local()], mesh, "data",
                                             generator)[0]
            pls = list(g.placements)
            pls[d] = Replicate()
            g = DTensor.from_local(mean * n, mesh, pls, run_check=False)
        out[name] = g
    return out


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    remat_policy: str | None = "full",
                    compress_grads: bool = False, mesh=None):
    """``train_step(model, opt_state, batch)``: the loss, its gradient by
    ``loss.backward()`` and one :func:`adamw_update`, IN PLACE; returns
    (model, opt_state, {"loss", "grad_norm"}) with both metrics as
    detached device scalars.  Switches the model's gradients on (its
    weights are registered without them) and clears them after the
    update.  ``compress_grads`` (with the ``mesh`` a DTensor model is
    placed on) sums the data-parallel gradients with the int8
    all-reduce (``runtime.compressed_grad_allreduce``, its noise from a
    generator seeded 0) instead of DTensor's own all-reduce."""
    if compress_grads and mesh is None:
        raise ValueError("compress_grads needs the mesh of a DTensor model")
    loss_fn = make_loss_fn(cfg, remat_policy)
    gen = []

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        loss = loss_fn(model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: p.grad for n, p in params.items()}
        if compress_grads:
            if not gen:
                gen.append(torch.Generator(loss.device).manual_seed(0))
            grads = _compressed(grads, mesh, gen[0])
        gnorm = adamw_update(grads, opt_state, params, lr=lr)
        for p in params.values():
            p.grad = None
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, S_max: int):
    api = get_api(cfg)

    def prefill(model, batch):
        if cfg.enc_dec:
            return api.prefill(model, (batch["frames"],
                                       batch["dec_tokens"]), cfg, S_max)
        if cfg.frontend == "vision_stub":
            return T.lm_prefill(model, batch["tokens"], cfg, S_max,
                                prefix_embeds=batch["patches"])
        return api.prefill(model, batch["tokens"], cfg, S_max)

    return prefill


def make_decode_step(cfg: ModelConfig):
    api = get_api(cfg)

    def decode(model, cache, token, pos):
        return api.decode_step(model, token, cache, pos, cfg)

    return decode


# ----------------------------------------------------------------------
# Fully-sharded abstract inputs for one (arch x shape x mesh) cell
# ----------------------------------------------------------------------
POLICIES = ("tp", "dp_only", "kv_seq")


def _strip_model(spec):
    """dp_only policy: drop every 'model' entry (replicate params)."""
    if isinstance(spec, P):
        return P(*[None if e == "model" else e for e in spec])
    if isinstance(spec, dict):
        return {k: _strip_model(v) for k, v in spec.items()}
    return type(spec)(_strip_model(s) for s in spec)


def _batch_all_axes(spec, mesh):
    """dp_only policy: shard the batch over EVERY mesh axis."""
    if isinstance(spec, P):
        return P(axis_names(mesh), *list(spec)[1:]) if len(spec) else spec
    return {k: _batch_all_axes(v, mesh) for k, v in spec.items()}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, policy: str = "tp"):
    """Everything one step of the cell needs, as DTensors on ``mesh``
    whose local shards are on the meta device (nothing allocated):
    {"params": the model, its parameters placed by their specs;
    "batch": the inputs; "opt_state" (train): the AdamW state, its
    moments ZeRO-1 placed; "cache" and "pos" (decode)}.

    policy: 'tp' (default: tensor parallel over the model axis) or
    'dp_only' (replicate params, shard the batch over all axes — the
    right call for small models where TP collectives dominate) or
    'kv_seq' (tp + decode KV cache sharded along sequence instead of
    kv-heads — for GQA archs whose few KV heads do not divide the model
    axis)."""
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r}: one of {POLICIES}")
    model, p_specs = abstract_params(cfg)
    if policy == "dp_only":
        p_specs = _strip_model(p_specs)
    out = {}
    if shape.kind == "train":
        out["opt_state"] = adamw_init(model, mesh, p_specs)
    out["params"] = shard_tree(model, p_specs, mesh)
    batch, b_specs = abstract_batch(cfg, shape)
    if policy == "dp_only":
        b_specs = _batch_all_axes(b_specs, mesh)
    out["batch"] = shard_tree(batch, b_specs, mesh)
    if shape.kind == "decode":
        cache, c_specs = abstract_cache(cfg, shape.batch, shape.seq)
        if policy == "kv_seq" and not cfg.mla and \
                cfg.family in ("dense", "moe", "vlm"):
            c_specs = (P(None, "data", "model", None, None),) * 2
        elif policy == "dp_only":
            c_specs = _strip_model(c_specs)
        out["cache"] = shard_tree(cache, c_specs, mesh)
        out["pos"] = torch.zeros((), dtype=torch.int32, device=_META)
    return out
