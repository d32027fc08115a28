"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, fine-grained experts
(d_ff_expert=1536). [hf:Qwen/Qwen3-30B-A3B family card, 235B row]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def qwen3_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        arch_type="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,                    # per-expert ffn width (no dense ffn)
        vocab_size=151936,
        qk_norm=True,
        act="silu",
        rope_theta=1e6,
        tie_embeddings=False,
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            d_ff_expert=1536,
            shared_expert_ff=0,
            every=1,
        ),
        source="hf:Qwen/Qwen3-30B-A3B (family card, 235B-A22B row)",
    )
