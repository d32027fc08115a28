"""pixtral-12b [vlm] — mistral-nemo style decoder consuming pixtral-ViT patch
embeddings.  The vision tower is a STUB per the assignment carve-out:
``input_specs`` supplies precomputed patch embeddings (batch, n_patches,
d_model). [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        arch_type="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        act="silu",
        rope_theta=1e6,
        tie_embeddings=False,
        num_patches=1024,             # stub ViT output: 1024 patch embeddings
        source="hf:mistralai/Pixtral-12B-2409",
    )
