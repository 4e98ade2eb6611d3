"""Fleet workload extraction: every LM config -> per-layer matmuls.

Walks a :class:`repro_torch.models.ModelConfig` (any of the 10 families
in ``repro_torch/configs/``: dense GQA decoders, MoE, MLA, encoder-decoder,
xLSTM, Mamba2 hybrids) and emits the matmul workloads one forward pass
executes, for a *prefill* (all sequence positions) or *decode* (one
token per sequence) phase.  Two invariants make the extraction
trustworthy rather than approximate, and tests pin both exactly:

* **parameter exactness** — summing ``K*N*param_instances`` over the
  prefill entries (plus the embedding table) reproduces
  ``ModelConfig.param_count()`` to the parameter, for every CONFIG and
  REDUCED config, because the walk mirrors ``param_count``'s per-layer
  branch structure rather than re-deriving shapes independently;
* **FLOP exactness** — ``2*M*K*N*count`` summed over entries matches
  closed-form per-family FLOP counts for both phases.

Repeated layers collapse at extraction time: the merge step keys on
``(name, M, K, N)`` so the 36 identical attention blocks of qwen3-4b
become ONE entry with ``count=36`` — the evaluation-side dedup
(`fleet.sweep.dedupe_shapes`) then collapses shape collisions *across*
entries and configs.

Sharding reuses the production resolver: ``shard_entries`` maps each
entry to its per-device shape under ``launch.sharding.resolve_spec``
(Megatron-style: column-parallel QKV/up projections split N on
"model", row-parallel out projections split K, token dims split on the
data axes, attention heads split on "model"; indivisible axes
replicate, exactly as the real launcher would).  :class:`MeshSpec` is a
topology-only mesh (``.shape``/``.axis_names``), with no device
allocation, so extraction works on one host with no 256-chip mesh.
"""
from __future__ import annotations

import dataclasses

from ..launch.mesh import production_mesh_shape
from ..launch.sharding import P, _axis_size, resolve_spec


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Topology-only mesh: satisfies the ``.shape[axis]`` /
    ``.axis_names`` duck type that ``resolve_spec`` consumes, without
    materializing devices."""

    axes: tuple[tuple[str, int], ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    """The production mesh's topology (16x16 data*model per pod)."""
    return MeshSpec(production_mesh_shape(multi_pod=multi_pod))


@dataclasses.dataclass(frozen=True)
class LayerMatmul:
    """One matmul shape a forward pass executes.

    ``count`` is how many times the shape runs per forward (e.g. once
    per layer, per head, per expert); ``param_instances`` is how many
    distinct K*N weight matrices it materializes (0 for
    activation-activation products like attention scores — their
    operands are produced, not stored).  ``tp`` tags the tensor-parallel
    style used by ``shard_entries``: "col" splits N, "row" splits K,
    "none" replicates the weight.
    """

    name: str
    M: int
    K: int
    N: int
    count: int = 1
    param_instances: int = 1
    tp: str = "none"

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.M, self.K, self.N)

    @property
    def weight_params(self) -> int:
        return self.K * self.N * self.param_instances

    @property
    def flops(self) -> int:
        return 2 * self.M * self.K * self.N * self.count


@dataclasses.dataclass(frozen=True)
class NetworkWorkloads:
    """All matmuls of one (config, phase), merged across identical
    layers.  ``extra_params`` carries non-matmul weights (the embedding
    lookup table)."""

    config: str
    phase: str
    matmuls: tuple[LayerMatmul, ...]
    extra_params: int = 0

    def weight_matmuls(self) -> tuple[LayerMatmul, ...]:
        return tuple(e for e in self.matmuls if e.param_instances > 0)

    def attention_matmuls(self) -> tuple[LayerMatmul, ...]:
        return tuple(e for e in self.matmuls if e.param_instances == 0)

    @property
    def total_params(self) -> int:
        """Exact parameter count (== cfg.param_count() for prefill,
        which touches every weight; decode skips encoder weights)."""
        return self.extra_params + sum(
            e.weight_params for e in self.matmuls)

    @property
    def total_flops(self) -> int:
        return sum(e.flops for e in self.matmuls)


# ----------------------------------------------------------------------
# extraction walk (mirrors ModelConfig.param_count branch-for-branch)
# ----------------------------------------------------------------------

def _attn_weights(cfg, T: int) -> list[LayerMatmul]:
    d = cfg.d_model
    if cfg.mla:
        m = cfg.mla
        h = cfg.num_heads
        return [
            LayerMatmul("mla_q_proj", T, d,
                        h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                        tp="col"),
            LayerMatmul("mla_kv_a_proj", T, d,
                        m.kv_lora_rank + m.qk_rope_head_dim, tp="none"),
            LayerMatmul("mla_kv_b_proj", T, m.kv_lora_rank,
                        h * (m.qk_nope_head_dim + m.v_head_dim),
                        tp="col"),
            LayerMatmul("mla_o_proj", T, h * m.v_head_dim, d, tp="row"),
        ]
    return [
        LayerMatmul("attn_qkv", T, d, cfg.q_dim + 2 * cfg.kv_dim,
                    tp="col"),
        LayerMatmul("attn_o_proj", T, cfg.q_dim, d, tp="row"),
    ]


def _attn_scores(cfg, prefix: str, q_len: int, kv_len: int,
                 n_seq: int, layer_count: int = 1) -> list[LayerMatmul]:
    if cfg.mla:
        qk_dim = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        v_dim = cfg.mla.v_head_dim
    else:
        qk_dim = v_dim = cfg.head_dim
    count = cfg.num_heads * n_seq * layer_count
    return [
        LayerMatmul(f"{prefix}_qk", q_len, qk_dim, kv_len,
                    count=count, param_instances=0),
        LayerMatmul(f"{prefix}_av", q_len, kv_len, v_dim,
                    count=count, param_instances=0),
    ]


def _ffn_weights(cfg, layer: int, T: int) -> list[LayerMatmul]:
    d = cfg.d_model
    out = []
    if cfg.is_moe_layer(layer):
        m = cfg.moe
        tok = max(1, (T * m.top_k) // m.num_experts)
        out.append(LayerMatmul("moe_router", T, d, m.num_experts,
                               tp="none"))
        out.append(LayerMatmul("moe_expert_gate_up", tok, d,
                               2 * m.expert_d_ff,
                               count=m.num_experts,
                               param_instances=m.num_experts, tp="col"))
        out.append(LayerMatmul("moe_expert_down", tok, m.expert_d_ff, d,
                               count=m.num_experts,
                               param_instances=m.num_experts, tp="row"))
        if m.num_shared_experts:
            out.append(LayerMatmul(
                "moe_shared_gate_up", T, d, 2 * m.shared_d_ff,
                count=m.num_shared_experts,
                param_instances=m.num_shared_experts, tp="col"))
            out.append(LayerMatmul(
                "moe_shared_down", T, m.shared_d_ff, d,
                count=m.num_shared_experts,
                param_instances=m.num_shared_experts, tp="row"))
    elif cfg.d_ff:
        out.append(LayerMatmul("ffn_gate_up", T, d, 2 * cfg.d_ff,
                               tp="col"))
        out.append(LayerMatmul("ffn_down", T, cfg.d_ff, d, tp="row"))
    return out


def _merge(entries: list[LayerMatmul]) -> tuple[LayerMatmul, ...]:
    """Collapse per-layer duplicates: same (name, M, K, N) becomes one
    entry with summed count / param_instances."""
    merged: dict = {}
    order = []
    for e in entries:
        key = (e.name, e.M, e.K, e.N, e.tp)
        if key in merged:
            old = merged[key]
            merged[key] = dataclasses.replace(
                old, count=old.count + e.count,
                param_instances=old.param_instances + e.param_instances)
        else:
            merged[key] = e
            order.append(key)
    return tuple(merged[k] for k in order)


def extract_network(cfg, phase: str = "prefill", *,
                    seq_len: int = 4096, batch: int | None = None,
                    ctx_len: int | None = None,
                    enc_len: int = 1500) -> NetworkWorkloads:
    """Emit the matmuls of one forward pass.

    prefill: every sequence position is live (T = batch * seq tokens,
    attention is q_len=seq vs kv_len=seq).  decode: one new token per
    sequence (T = batch tokens, attention is q_len=1 vs the kv cache of
    ``ctx_len`` positions).  ``attn_window`` caps kv_len in both.
    Returns GLOBAL (unsharded) shapes; apply :func:`shard_entries` for
    per-device shapes.
    """
    if phase not in ("prefill", "decode"):
        raise ValueError(f"phase must be prefill|decode, got {phase!r}")
    if batch is None:
        batch = 16 if phase == "prefill" else 256
    d = cfg.d_model
    dec_seq = min(seq_len, cfg.dec_max_len) if cfg.enc_dec else seq_len
    ctx = min(ctx_len or dec_seq, cfg.dec_max_len) if cfg.enc_dec \
        else (ctx_len or seq_len)
    if phase == "prefill":
        q_len, kv_len, T = dec_seq, dec_seq, dec_seq * batch
    else:
        q_len, kv_len, T = 1, ctx, batch
    if cfg.attn_window:
        kv_len = min(kv_len, cfg.attn_window)

    entries: list[LayerMatmul] = []
    for layer in range(cfg.num_layers):
        kind = cfg.block_kind(layer)
        if kind == "attn":
            entries += _attn_weights(cfg, T)
            entries += _attn_scores(cfg, "attn", q_len, kv_len, batch)
        elif kind == "mamba2":
            di = cfg.ssm_expand * d
            entries += [
                LayerMatmul("ssm_in_proj", T, d, 2 * di, tp="col"),
                LayerMatmul("ssm_out_proj", T, di, d, tp="row"),
                LayerMatmul("ssm_bcdt_proj", T, di,
                            2 * cfg.ssm_state + 3, tp="none"),
            ]
        else:  # xlstm blocks (mlstm / slstm)
            di = cfg.ssm_expand * d
            entries += [
                LayerMatmul(f"{kind}_up_proj", T, d, 2 * di, tp="col"),
                LayerMatmul(f"{kind}_down_proj", T, di, d, tp="row"),
            ]
        if kind == "attn" or cfg.family not in ("ssm",):
            entries += _ffn_weights(cfg, layer, T)

    if cfg.hybrid and cfg.hybrid.shared_attn_d_ff:
        # one SHARED attention block applied num_layers // period times:
        # weights materialize once (param_instances stays 1 per matmul),
        # compute repeats per application
        apps = cfg.num_layers // cfg.hybrid.period
        sd = cfg.hybrid.shared_attn_d_ff
        entries += [
            LayerMatmul("shared_attn_qkv", T, d,
                        cfg.q_dim + 2 * cfg.kv_dim, count=apps, tp="col"),
            LayerMatmul("shared_attn_o_proj", T, cfg.q_dim, d,
                        count=apps, tp="row"),
            LayerMatmul("shared_ffn_gate_up", T, d, 2 * sd,
                        count=apps, tp="col"),
            LayerMatmul("shared_ffn_down", T, sd, d,
                        count=apps, tp="row"),
        ]
        entries += _attn_scores(cfg, "shared_attn", q_len, kv_len,
                                batch, layer_count=apps)

    if cfg.enc_dec:
        T_enc = enc_len * batch
        if phase == "prefill":
            # encoder runs once, at prefill
            entries += [
                LayerMatmul("enc_qkv", T_enc, d, 3 * d,
                            count=cfg.enc_layers,
                            param_instances=cfg.enc_layers, tp="col"),
                LayerMatmul("enc_o_proj", T_enc, d, d,
                            count=cfg.enc_layers,
                            param_instances=cfg.enc_layers, tp="row"),
                LayerMatmul("enc_ffn_gate_up", T_enc, d, 2 * cfg.d_ff,
                            count=cfg.enc_layers,
                            param_instances=cfg.enc_layers, tp="col"),
                LayerMatmul("enc_ffn_down", T_enc, cfg.d_ff, d,
                            count=cfg.enc_layers,
                            param_instances=cfg.enc_layers, tp="row"),
            ]
            entries += _attn_scores(cfg, "enc_attn", enc_len, enc_len,
                                    batch, layer_count=cfg.enc_layers)
            # cross-attention K/V projections over encoder memory run
            # once at prefill and are cached for decode
            entries += [
                LayerMatmul("cross_k_proj", T_enc, d, d,
                            count=cfg.num_layers,
                            param_instances=cfg.num_layers, tp="col"),
                LayerMatmul("cross_v_proj", T_enc, d, d,
                            count=cfg.num_layers,
                            param_instances=cfg.num_layers, tp="col"),
            ]
        # cross-attention Q/O run per decoder step in both phases
        entries += [
            LayerMatmul("cross_q_proj", T, d, d, count=cfg.num_layers,
                        param_instances=cfg.num_layers, tp="col"),
            LayerMatmul("cross_o_proj", T, d, d, count=cfg.num_layers,
                        param_instances=cfg.num_layers, tp="row"),
        ]
        entries += _attn_scores(cfg, "cross_attn", q_len, enc_len,
                                batch, layer_count=cfg.num_layers)

    entries.append(LayerMatmul("lm_head", T, d, cfg.vocab_size,
                               tp="col"))
    # embedding table: a lookup, not a matmul (tied -> lm_head weight)
    extra = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return NetworkWorkloads(config=cfg.name, phase=phase,
                            matmuls=_merge(entries), extra_params=extra)


# ----------------------------------------------------------------------
# production sharding
# ----------------------------------------------------------------------

def _shard_dim(size: int, axis, mesh) -> int:
    if mesh is None or axis is None:
        return size
    spec = resolve_spec(P(axis), (size,), mesh)
    entry = spec[0] if len(spec) else None
    return size // _axis_size(mesh, entry)


def shard_entries(net: NetworkWorkloads, mesh) -> NetworkWorkloads:
    """Per-device shapes under ``mesh`` (a MeshSpec).

    Token dims (M) split over the data axes; "col" weights split N and
    "row" weights split K over "model"; attention score counts split
    heads over "model" and sequences over data.  Indivisible splits
    replicate (resolve_spec semantics) — shapes never go fractional.
    """
    if mesh is None:
        return net
    out = []
    for e in net.matmuls:
        if e.param_instances == 0:
            # count = heads * n_seq * layers; shard the head product on
            # "model" and the sequence product on the data axes
            count = _shard_dim(e.count, "model", mesh)
            count = _shard_dim(count, "data", mesh)
            out.append(dataclasses.replace(e, count=max(1, count)))
            continue
        M = max(1, _shard_dim(e.M, "data", mesh))
        K, N = e.K, e.N
        if e.tp == "col":
            N = _shard_dim(N, "model", mesh)
        elif e.tp == "row":
            K = _shard_dim(K, "model", mesh)
        out.append(dataclasses.replace(e, M=M, K=K, N=N))
    return dataclasses.replace(net, matmuls=tuple(out))


def extract_fleet(config_names, *, reduced: bool = False,
                  phases=("prefill", "decode"), mesh=None,
                  seq_len: int = 4096,
                  batch: int | None = None) -> list[NetworkWorkloads]:
    """Extract (and optionally shard) every (config, phase) of a fleet."""
    from ..configs import get_config
    nets = []
    for name in config_names:
        cfg = get_config(name, reduced=reduced)
        for phase in phases:
            net = extract_network(cfg, phase, seq_len=seq_len,
                                  batch=batch)
            nets.append(shard_entries(net, mesh))
    return nets
