"""padded_position_share: of the positions the split halves computed in
the traced segment (each ``split.<kind>`` root span's
``computed_positions``, the bank's bucket-padded B·S), the share that is
padding (``computed_positions - real_positions``), in percent."""
from bench.spans import records


def read(run):
    roots = [r for r in records(run) or ()
             if r.parent is None and r.name.startswith("split.")]
    computed = sum(r.counts["computed_positions"] for r in roots)
    if computed <= 0:
        return None
    real = sum(r.counts["real_positions"] for r in roots)
    return 100.0 * (computed - real) / computed
