"""The port's model config for a Qwen3 configuration file: every number
the program runs is taken from the file, and a setting the program's dense
model cannot run raises rather than run something else."""
from __future__ import annotations


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig

    unsupported = {"attention_bias": False, "hidden_act": "silu",
                   "rope_scaling": None, "sliding_window": None,
                   "use_sliding_window": False}
    for key, want in unsupported.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{cfg['name']}: {key}={cfg[key]!r} is not what "
                             f"the port's dense Qwen3 runs ({want!r})")
    return ModelConfig(
        name=cfg["name"], arch_type="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        qk_norm=True, act="silu", rope_theta=float(cfg["rope_theta"]),
        rms_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        source=cfg["source"])
