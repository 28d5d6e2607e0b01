#!/usr/bin/env python3
"""Detector training at a short warm-up, the JAX trainer and the port side by
side on the CPU: does the loss spike at the same steps in both?

    JAX_PLATFORMS=cpu python scripts/compare_train_warmup.py \
        [--input 320] [--batch 8] [--scan 25] [--dispatches 3] [--warmup 10]

Both trainers start from JAX's init of YOLOv8n (f32, ``template_params``)
carried into the port, draw the same scenes from the same keys
(``TrainConfig``'s seed, the default 540x960 world) and run in f32 with
``TrainConfig``'s learning rate, schedule horizon and weight decay; only the
warm-up and the network's input size are set here. The input is cut below
640x640 to keep the CPU's memory small: the scenes, the schedule and the
net's widths are ``TrainConfig``'s. Prints one line a step (learning rate,
both losses, their ratio) and a JSON summary: each trainer's mean loss a
dispatch and the steps whose loss exceeds ``--spike`` times the median of
the dispatch. At the defaults it takes ~13 minutes on 8 CPU cores and
~2.4 GB, most of it JAX's steps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spikes(losses, factor):
    """Steps (1-based) whose loss exceeds ``factor`` times the median of
    their dispatch's losses."""
    import numpy as np
    out = []
    for d, row in enumerate(losses):
        med = float(np.median(row))
        out += [d * len(row) + i + 1 for i, v in enumerate(row)
                if v > factor * med]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", type=int, default=320,
                    help="square network input (TrainConfig trains at 640)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scan", type=int, default=25)
    ap.add_argument("--dispatches", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--spike", type=float, default=10.0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from aicamera_tpu import train as jt
    from aicamera_tpu.models import YOLOv8 as JYOLO
    from aicamera_tpu.ops.preprocess import letterbox_spec as jspec
    from aicamera_tpu.runtime.params import template_params
    from aicamera_tpu.synthetic import WorldSpec as JWorld
    from aicamera_tpu_torch import prng
    from aicamera_tpu_torch import train as tt
    from aicamera_tpu_torch.models.yolov8 import YOLOv8
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.runtime import params
    from aicamera_tpu_torch.synthetic import WorldSpec

    torch.set_num_threads(args.threads)
    in_hw = (args.input, args.input)
    base = tt.TrainConfig()
    kw = dict(batch=args.batch, scan=args.scan, warmup=args.warmup)
    jcfg, tcfg = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    world = WorldSpec()
    sched = tt.warmup_cosine_schedule(base.lr, args.warmup,
                                      max(base.steps, args.warmup + 1),
                                      base.lr / 20)

    jm = JYOLO(variant="n", dtype=jnp.float32)
    p0 = jax.jit(lambda: template_params(
        jm, jnp.zeros((1, 64, 64, 3), jnp.float32)))()
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(
            0.0, base.lr, args.warmup, max(base.steps, args.warmup + 1),
            base.lr / 20), weight_decay=base.weight_decay))
    jstep = jt.make_train_step(jm, JWorld(), jspec(world.hw, in_hw), in_hw,
                               jcfg, tx)
    model = YOLOv8("n")
    params.load_state_strict(model, params.yolo_state_dict_from_flax(
        jax.tree.map(np.asarray, p0)))
    opt = tt.make_optimizer(model, base.lr, args.warmup, base.steps,
                            base.weight_decay)
    tstep = tt.make_train_step(model, world, letterbox_spec(world.hw, in_hw),
                               in_hw, tcfg, opt, dtype=torch.float32)

    jp, js = p0, tx.init(p0)
    jkey, tkey = jax.random.PRNGKey(base.seed), prng.PRNGKey(base.seed)
    jl, tl = [], []
    for d in range(args.dispatches):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        t0 = time.perf_counter()
        jp, js, losses, _ = jstep(jp, js, jsub)
        jl.append(np.asarray(losses, np.float64))
        t1 = time.perf_counter()
        losses, _ = tstep(tsub)
        tl.append(losses.numpy().astype(np.float64))
        t2 = time.perf_counter()
        for i in range(args.scan):
            n = d * args.scan + i
            print(f"step {n + 1:4d} lr {sched(n):.6g} jax {jl[-1][i]:.6g} "
                  f"port {tl[-1][i]:.6g} port/jax "
                  f"{tl[-1][i] / jl[-1][i]:.6g}", flush=True)
        print(f"dispatch {d + 1}: jax {t1 - t0:.1f} s, port {t2 - t1:.1f} s",
              flush=True)
    summary = {
        "input_hw": list(in_hw), "batch": args.batch, "scan": args.scan,
        "warmup": args.warmup, "lr": base.lr, "horizon": base.steps,
        "jax_mean": [float(r.mean()) for r in jl],
        "port_mean": [float(r.mean()) for r in tl],
        "jax_spikes": spikes(jl, args.spike),
        "port_spikes": spikes(tl, args.spike),
        "jax_max": float(max(r.max() for r in jl)),
        "port_max": float(max(r.max() for r in tl)),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
