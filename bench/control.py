"""The readings the correctness limits are set from, on the card.

    python3 -m bench.control --workload <cell> --seeds 11,12,13 --seconds 6

runs, in one process, the cell's set-up, a short window at the cell's
load and the check for each seed, and prints one JSON line a seed: the
program's numbers (the lower readings) and the control's on the same
sample: the reference computed in float8 (e4m3 GEMMs, the nearest
precision below the configuration's bfloat16) in the program's place (the
upper readings).  The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    args = p.parse_args(argv)

    from bench import check
    from bench.harness import ROOT, Cell, run_cell
    import torch
    if not torch.cuda.is_available():
        print("bench.control: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    cell = Cell.load(args.workload)

    def control(ref, params, butterfly, rows, ref_logits):
        t = time.perf_counter()
        ctl = check.reference_logits(ref, params, butterfly, cell.cfg, rows,
                                     mm=ref.fp8_mm)
        out = check.control_numbers(ctl, ref_logits)
        out["seconds"] = time.perf_counter() - t
        return out

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result = run_cell(cell, seed, args.seconds, False, "cuda",
                          time.perf_counter(),
                          kind=torch.cuda.get_device_name(0), inspect=control)
        line = {"seed": seed, "correct": result["correct"],
                "program": {k: v["value"] for k, v in result["check"].items()},
                "control": result.get("inspect"),
                "requests": result["attempted"],
                "phases_s": result["phases_s"], "metrics": result["metrics"],
                "peak": result["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
