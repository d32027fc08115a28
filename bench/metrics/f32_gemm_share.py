"""f32_gemm_share: device time in float32 GEMM kernels over all device
time in the traced segment, in percent.  With TF32 off and bf16 weights,
the float32 products are attention's scores and values."""
import re

# cuBLAS names of float32 GEMMs on the CUDA cores (the H100's read
# ``sm80_xmma_gemm_f32f32_f32f32_f32_..._ffma_...``); a TF32 kernel's
# names its inputs tf32 and is not counted
F32_GEMM = re.compile(r"sgemm|gemm_f32f32_f32f32", re.IGNORECASE)


def read(run):
    t = run.trace
    if t is None or not t.device_events:
        return None
    total = sum(e - s for _, s, e in t.device_events)
    f32 = sum(e - s for name, s, e in t.device_events if F32_GEMM.search(name))
    return 100.0 * f32 / total if total > 0 else None
