"""zamba2-7b [hybrid] — Mamba2 backbone with a *shared-parameter* attention
block applied periodically (every 6th position here), ssm_state=64.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,                   # shared-attention block ffn
        vocab_size=32000,
        act="gelu",
        rope_theta=1e4,
        tie_embeddings=True,
        hybrid_attn_every=6,          # layer i is shared-attn when i % 6 == 5
        # d_inner = 2*d_model = 7168 = 64 heads x 112; 64 heads shard evenly
        # over the 16-way model axis (DESIGN.md section 6)
        ssm=SSMConfig(state_dim=64, num_heads=64, head_dim=112,
                      conv_width=4, chunk_size=128, expand=2),
        source="arXiv:2411.15242 (Zamba2-7B: 81 blocks, shared attn, ssm_state=64)",
    )
