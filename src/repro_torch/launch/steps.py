"""Step builders: abstract shapes and step functions for training,
prefill and decode (the JAX package's ``launch/steps.py``), shared by
``train.py`` and the chip smoke test.

The abstract inputs live on the ``meta`` device: even the 76B-parameter
configurations are described without allocating a byte.  Sharded
inputs (``input_specs``) wait for mesh sharding (ROADMAP item 6).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import ModelConfig, get_api, lm_loss_from_hidden
from ..models import transformer as T
from ..optim import adamw_update
from .sharding import PartitionSpec as P

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
    """The model of ``cfg`` on the meta device: every parameter's shape
    and dtype, nothing allocated (the reference also returns its
    partition specs, which wait for mesh sharding)."""
    return get_api(cfg).init(cfg, None, _META)


def abstract_cache(cfg: ModelConfig, B: int, S: int):
    """Cache/state tensors on the meta device + their spec tree, for
    decode."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.enc_dec:
        def kv(s):
            return torch.empty((cfg.num_layers, B, s, cfg.num_kv_heads,
                                cfg.head_dim), dtype=dtype, device=_META)
        shapes = ((kv(cfg.dec_max_len), kv(cfg.dec_max_len)), (kv(S), kv(S)))
        self_spec = P(None, "data", None, "model", None)
        cross_spec = P(None, "data", "model", None, None)
        return shapes, ((self_spec, self_spec), (cross_spec, cross_spec))
    if cfg.family == "ssm":
        m_spec = (P(None, "data", None, "model"),
                  P(None, "data", None, None, None))
        s_spec = (P(None, "data", "model"),) * 4
        return T.xlstm_init_state(cfg, B, dtype, _META), (m_spec, s_spec)
    if cfg.family == "hybrid":
        mamba_spec = (P(None, None, "data", None, "model"),
                      P(None, None, "data", "model", None, None))
        kv_spec = (P(None, "data", None, "model", None),) * 2
        return (T.hybrid_init_state(cfg, B, S, dtype, _META),
                (mamba_spec, kv_spec))
    if cfg.mla:
        specs = (P(None, "data", None, None),) * 2
    else:
        specs = (P(None, "data", None, "model", None),) * 2
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


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    remat_policy: str | None = "full"):
    """``train_step(model, opt_state, batch)``: the loss, its gradient by
    ``loss.backward()`` and one :func:`adamw_update`, IN PLACE; returns
    (model, opt_state, {"loss", "grad_norm"}) with both metrics as
    detached device scalars.  Switches the model's gradients on (its
    weights are registered without them) and clears them after the
    update."""
    loss_fn = make_loss_fn(cfg, remat_policy)

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        loss = loss_fn(model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        gnorm = adamw_update({n: p.grad for n, p in params.items()},
                             opt_state, params, lr=lr)
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


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, policy: str = "tp"):
    """Sharded abstract inputs for one (arch x shape x mesh) cell: not
    ported, since the port has no mesh sharding (ROADMAP Queue 1 item
    6); raises."""
    raise NotImplementedError("input_specs: mesh sharding is not ported yet "
                              "(ROADMAP Queue 1 item 6)")
