"""Quickstart (the port's counterpart of ``examples/quickstart.py``): build
a reduced model with the paper's butterfly unit, train it end to end on the
synthetic LM stream, checkpoint, restore and serve.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.configs import get_config
from repro_torch.data import lm_batches
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import (AdamWConfig, adamw_init, constant_schedule,
                                  make_train_step)
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises if it is missing")
    device = dev_lib.resolve(ap.parse_args(argv).device)

    # 1. a reduced qwen3 with the butterfly bottleneck after layer 1
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), vocab_size=128)
    cfg = cfg.with_butterfly(layer=1, d_r=16)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=device).manual_seed(0), built,
                          device=device)
    print(f"model: {cfg.name}, butterfly after layer {cfg.butterfly.layer} "
          f"(d_model {cfg.d_model} -> d_r {cfg.butterfly.d_r}, int8 wire)")

    # 2. train end-to-end THROUGH the quantized bottleneck (paper Sec. II)
    opt = adamw_init(params)
    step = make_train_step(built, AdamWConfig(lr=constant_schedule(3e-3)))
    for i, raw in zip(range(80), lm_batches(cfg.vocab_size, 64, 16)):
        batch = {k: dev_lib.as_tensor(v, device) for k, v in raw.items()}
        params, opt, metrics = step(params, opt, batch)
        if i % 20 == 0 or i == 79:
            print(f"  step {i:3d} loss {float(metrics['loss']):.3f}")

    # 3. checkpoint round-trip
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(f"{d}/ckpt", params, opt, step=80)
        params, _, meta = restore_checkpoint(path, params)
        print("checkpoint restored:", meta)

    # 4. serve a few requests (prefill + batched ragged decode)
    eng = ServingEngine(params, built, max_batch=4, max_len=128, device=device)
    reqs = [eng.submit(np.arange(1 + i, 9 + i) % cfg.vocab_size,
                       max_new_tokens=12) for i in range(3)]
    eng.run()
    for r in reqs:
        print(f"  request {r.uid}: generated {r.generated}")


if __name__ == "__main__":
    main()
