"""llama4-maverick-400b-a17b [moe] — 128 experts, top-1 routing, one shared
expert, MoE on every other layer (interleave step 2), early-fusion multimodal
backbone (text path here). [hf:meta-llama/Llama-4-Scout-17B-16E family card]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("llama4-maverick-400b-a17b")
def llama4_maverick() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        arch_type="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,                    # dense-layer / shared-expert ffn width
        vocab_size=202048,
        act="silu",
        rope_theta=5e5,
        tie_embeddings=False,
        moe=MoEConfig(
            num_experts=128,
            top_k=1,
            d_ff_expert=8192,
            shared_expert_ff=8192,
            every=2,                  # MoE every other layer (maverick card)
        ),
        source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick row: 128e top-1, interleaved MoE)",
    )
