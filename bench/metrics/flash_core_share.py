"""flash_core_share: of the program's ``mixer.attn.core`` spans in the
traced segment, the share whose core ran the flash kernel (each span's
``flash`` count, 1 for the kernel and 0 for the plain S×S scores), in
percent.  Nothing where no core span counts ``flash``."""
from bench.spans import records


def read(run):
    cores = [r for r in records(run) or () if r.name == "mixer.attn.core"]
    if not cores or any("flash" not in r.counts for r in cores):
        return None
    return 100.0 * sum(r.counts["flash"] for r in cores) / len(cores)
