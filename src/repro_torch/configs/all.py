"""Import every per-arch config module so the registry is populated."""
import repro_torch.configs.qwen3_14b      # noqa: F401
import repro_torch.configs.qwen3_8b       # noqa: F401
import repro_torch.configs.llama4_maverick  # noqa: F401
import repro_torch.configs.qwen3_moe      # noqa: F401
import repro_torch.configs.pixtral_12b    # noqa: F401
import repro_torch.configs.whisper_base   # noqa: F401
import repro_torch.configs.gemma_7b       # noqa: F401
import repro_torch.configs.gemma3_12b     # noqa: F401
import repro_torch.configs.xlstm_125m     # noqa: F401
import repro_torch.configs.zamba2_7b      # noqa: F401
import repro_torch.configs.resnet50       # noqa: F401

ASSIGNED = [
    "qwen3-14b",
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
    "pixtral-12b",
    "whisper-base",
    "gemma-7b",
    "gemma3-12b",
    "qwen3-8b",
    "xlstm-125m",
    "zamba2-7b",
]
