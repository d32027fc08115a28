"""Analytic FLOPs/bytes accounting used by the planner's profiling phase and
by the roofline MODEL_FLOPS (useful-compute) denominator.

Conventions: multiply-add = 2 FLOPs; forward pass only (the planner splits
inference).  MODEL_FLOPS for LM training steps uses the standard 6*N*D
(N params, D tokens) with N_active for MoE.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.resnet50 import ResNetConfig

# ---------------------------------------------------------------------------
# transformer per-layer accounting
# ---------------------------------------------------------------------------


def attn_layer_flops(cfg: ModelConfig, seq: int, window: Optional[int] = None,
                     kv_len: Optional[int] = None) -> float:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    proj = 2 * seq * d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    kv = kv_len if kv_len is not None else seq
    eff = min(kv, window) if window else kv
    attn = 2 * seq * eff * cfg.num_heads * hd * 2      # scores + values
    return proj + attn


def mlp_flops(d: int, ff: int, seq: int) -> float:
    return 2 * seq * d * ff * 3


def moe_layer_flops(cfg: ModelConfig, seq: int) -> float:
    m = cfg.moe
    routed = mlp_flops(cfg.d_model, m.d_ff_expert, seq) * m.top_k
    shared = mlp_flops(cfg.d_model, m.shared_expert_ff, seq) if m.shared_expert_ff else 0
    router = 2 * seq * cfg.d_model * m.num_experts
    return routed + shared + router


def mamba_layer_flops(cfg: ModelConfig, seq: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.num_heads * s.head_dim
    proj = 2 * seq * d * (2 * d_inner + 2 * s.state_dim + s.num_heads)
    proj += 2 * seq * d_inner * d
    L = min(s.chunk_size, seq)
    ssd = 2 * seq * L * s.state_dim * 2 + 2 * seq * L * s.head_dim * s.num_heads
    state = 2 * seq * s.num_heads * s.head_dim * s.state_dim * 2
    return proj + ssd + state


def xlstm_layer_flops(cfg: ModelConfig, seq: int, kind: str) -> float:
    d = cfg.d_model
    if kind == "mlstm":
        d_inner = 2 * d
        proj = 2 * seq * d * d_inner * 3 + 2 * seq * d_inner * d_inner * 3 + \
            2 * seq * d_inner * d
        L = min(cfg.xlstm.chunk_size, seq)
        mix = 2 * seq * L * d_inner * 2
        return proj + mix
    # slstm: 4 gate projections + per-head recurrent + small ffn
    H = cfg.num_heads
    Pd = d // H
    rec = 2 * seq * 4 * H * Pd * Pd
    ff = int(d * 8 / 3) // 64 * 64
    return 2 * seq * d * 4 * d + rec + 2 * seq * d * ff * 2


def layer_flops(cfg: ModelConfig, layer_idx: int, seq: int,
                long_mode: bool = False, kv_len: Optional[int] = None) -> float:
    from repro_torch.models.transformer import build_layer_defs
    ldef = build_layer_defs(cfg, long_mode)[layer_idx]
    if ldef.mixer == "attn":
        f = attn_layer_flops(cfg, seq, ldef.window, kv_len)
        if ldef.cross:
            f += attn_layer_flops(cfg, seq, None, cfg.encoder_frames)
        if ldef.ffn == "mlp":
            f += mlp_flops(cfg.d_model, cfg.d_ff, seq)
        elif ldef.ffn == "moe":
            f += moe_layer_flops(cfg, seq)
        return f
    if ldef.mixer == "mamba":
        return mamba_layer_flops(cfg, seq)
    return xlstm_layer_flops(cfg, seq, ldef.mixer)


def stack_flops(cfg: ModelConfig, seq: int, lo: int = 0, hi: Optional[int] = None,
                long_mode: bool = False, kv_len: Optional[int] = None) -> float:
    hi = cfg.num_layers if hi is None else hi
    return sum(layer_flops(cfg, i, seq, long_mode, kv_len) for i in range(lo, hi))


def embed_flops(cfg: ModelConfig, seq: int) -> float:
    return 2 * seq * cfg.d_model * cfg.vocab_size      # unembed matmul


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------


def param_count(cfg: ModelConfig, active_only: bool = False) -> float:
    from repro_torch.models.transformer import build_layer_defs
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    shared_attn_counted = False
    for ldef in build_layer_defs(cfg):
        if ldef.mixer == "attn":
            if not (ldef.shared and shared_attn_counted):
                total += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
                if ldef.ffn == "mlp" or ldef.shared:
                    total += 3 * d * cfg.d_ff
                if ldef.shared:
                    shared_attn_counted = True
            if ldef.ffn == "moe":
                m = cfg.moe
                n_exp = m.top_k if active_only else m.num_experts
                total += n_exp * 3 * d * m.d_ff_expert
                total += d * m.num_experts
                if m.shared_expert_ff:
                    total += 3 * d * m.shared_expert_ff
            if ldef.cross:
                total += d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
        elif ldef.mixer == "mamba":
            s = cfg.ssm
            din = s.num_heads * s.head_dim
            total += d * (2 * din + 2 * s.state_dim + s.num_heads) + din * d
        elif ldef.mixer == "mlstm":
            din = 2 * d
            total += d * din * 2 + din * din * 3 + din * d
        elif ldef.mixer == "slstm":
            H, Pd = cfg.num_heads, d // cfg.num_heads
            ff = int(d * 8 / 3) // 64 * 64
            total += d * 4 * d + 4 * H * Pd * Pd + 2 * d * ff
    if cfg.is_encdec:
        per_enc = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2) + 3 * d * cfg.d_ff
        total += cfg.encoder_layers * per_enc
    return float(total)


def model_flops_train(cfg: ModelConfig, tokens: int) -> float:
    """The 6*N*D convention (N_active for MoE)."""
    return 6.0 * param_count(cfg, active_only=True) * tokens


def model_flops_decode(cfg: ModelConfig, batch: int) -> float:
    """2*N_active per token forward."""
    return 2.0 * param_count(cfg, active_only=True) * batch


# ---------------------------------------------------------------------------
# per-token split-decode accounting (the streamed decode transport)
# ---------------------------------------------------------------------------

# sampled token ids travel the downlink as int32
TOKEN_BYTES = 4.0


def layer_param_count(cfg: ModelConfig, active_only: bool = True) -> float:
    """Params in the layer stack only (embedding/head tables excluded)."""
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return param_count(cfg, active_only) - emb


def _act_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def model_parallel_share(cost, mp: int = 1):
    """Per-device share of a ``(flops, bytes)`` pair when the stage is
    sharded over a model axis of degree ``mp``: attention heads, d_ff
    columns and experts divide, so FLOPs and weight-streaming bytes both
    scale 1/mp (Megatron column->row sharding).  Activation replication and
    the per-layer psum are not charged — ideal scaling, matching the
    planner's bytes-proxy granularity.  ``mp <= 1`` is the identity, so
    un-sharded callers keep their exact historical estimates."""
    if mp <= 1:
        return cost
    f, b = cost
    return f / mp, b / mp


def full_decode_step_cost(cfg: ModelConfig, batch: int = 1):
    """(flops, weight_bytes) for one full-model decode step (weight-bound:
    every step streams the whole parameter set) — the cost of a cloud-side
    cache-handoff decode turn, used by both the runtime CostModel and the
    planner so the selection phase scores what the simulator charges."""
    return model_flops_decode(cfg, batch), param_count(cfg) * _act_bytes(cfg)


def edge_decode_step_cost(cfg: ModelConfig, split: int, d_r: int):
    """(flops, weight_bytes) per generated token for the edge's streamed
    half: embed lookup + layers [0, split) + the reduction unit.  Decode is
    weight-bound, so bytes stream the edge layers' parameter share."""
    ab = _act_bytes(cfg)
    lp = layer_param_count(cfg) * split / cfg.num_layers
    flops = 2.0 * lp + 2.0 * cfg.d_model * d_r
    nbytes = lp * ab + cfg.d_model * ab            # one embedding row
    return flops, nbytes


def cloud_decode_step_cost(cfg: ModelConfig, split: int, d_r: int,
                           batch: int = 1):
    """(flops, weight_bytes) per decode turn for the cloud's streamed half:
    restoration unit + layers [split, N) + the unembed matmul."""
    ab = _act_bytes(cfg)
    lp = layer_param_count(cfg) * (cfg.num_layers - split) / cfg.num_layers
    flops = batch * (2.0 * lp + 2.0 * d_r * cfg.d_model + embed_flops(cfg, 1))
    nbytes = lp * ab + cfg.vocab_size * cfg.d_model * ab
    return flops, nbytes


def kv_cache_bytes(cfg: ModelConfig, seq: int, layers: int) -> float:
    """KV-cache bytes for ``layers`` attention layers over a ``seq``-token
    prompt: K and V, ``num_kv_heads`` heads of ``head_dim`` each.  This is
    what the cache-handoff decode transport ships up the wire per edge
    layer (and what the selection phase charges it per split)."""
    per_layer = 2 * seq * cfg.num_kv_heads * cfg.resolved_head_dim * \
        _act_bytes(cfg)
    return float(per_layer * layers)


# ---------------------------------------------------------------------------
# resnet accounting (paper's arch)
# ---------------------------------------------------------------------------


def resnet_block_flops(cfg: ResNetConfig, block: int) -> float:
    """Forward FLOPs of residual block ``block`` (1-based)."""
    chans = cfg.block_channels()
    spatial = cfg.block_spatial()
    cout = chans[block - 1]
    sp = spatial[block - 1]
    cin = cfg.stem_channels if block == 1 else chans[block - 2]
    mid = cout // 4
    f = 2 * sp * sp * (cin * mid + 9 * mid * mid + mid * cout)
    if cin != cout:
        f += 2 * sp * sp * cin * cout
    return float(f)


def resnet_stem_flops(cfg: ResNetConfig) -> float:
    sp = cfg.image_size // 2
    return float(2 * sp * sp * 49 * 3 * cfg.stem_channels)


def resnet_split_flops(cfg: ResNetConfig, split: int, d_r: int):
    """(edge_flops, cloud_flops, wire_bytes) for a butterfly after ``split``."""
    chans = cfg.block_channels()
    spatial = cfg.block_spatial()
    edge = resnet_stem_flops(cfg) + sum(resnet_block_flops(cfg, b)
                                        for b in range(1, split + 1))
    edge += 2 * spatial[split - 1] ** 2 * chans[split - 1] * d_r   # reduction
    cloud = 2 * spatial[split - 1] ** 2 * d_r * chans[split - 1]   # restoration
    cloud += sum(resnet_block_flops(cfg, b)
                 for b in range(split + 1, cfg.num_blocks + 1))
    cloud += 2 * chans[-1] * cfg.num_classes
    wire = cfg.feature_bytes(split, bits=8, channels=d_r)
    return edge, cloud, wire
