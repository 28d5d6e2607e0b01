"""Multi-stream tracking, on one device or sharded over a world of ranks.

Eight independent camera streams advance in lockstep: every step batches
all S frames through one detect+embed pass (one letterbox launch for all
of them), then one tracker step over the stack of the S streams' states
(a batched assignment launch for all streams' problems). By default the
stack runs on one device in this process. ``--ranks N`` starts a world of
N ranks (``parallel.distributed.spawn``) and shards the streams over
``make_stream_mesh()``: every rank is given every stream's frames, runs
its S / N streams, and one gather a step brings all streams' outputs to
every rank (tracker state is per stream: no other collective). Ranks
share the cards round-robin; where they outnumber the cards the world uses
gloo (NCCL refuses two ranks on one GPU), as on the CPU.

    python examples_torch/multistream.py [--device cpu] [--steps 4]
        [--streams 8] [--ranks N]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import parse_args, demo_frame  # noqa: E402

HW = (288, 512)


def run_steps(pipe, n_streams, steps):
    """Confirmed tracks per stream after each of ``steps`` steps."""
    import numpy as np
    counts = []
    for t in range(steps):
        frames = np.stack([demo_frame(HW, seed=100 * s + t)
                           for s in range(n_streams)])
        tlbr, ids, cls, conf, mask = pipe.step(frames)
        counts.append(mask.sum(dim=-1).tolist())
    return counts


def rank_main(rank, device, n_streams, steps):
    """One rank of the world (a module-level function: ``spawn`` imports
    it by name in every rank): the stream-sharded pipeline, every stream's
    frames, and this rank's kernel launches."""
    import torch.distributed as dist
    from aicamera_tpu_torch.parallel import (MultiStreamPipeline,
                                             make_stream_mesh)
    from aicamera_tpu_torch.runtime.engine import KERNELS
    mesh = make_stream_mesh()
    pipe = MultiStreamPipeline(n_streams=n_streams, frame_hw=HW, mesh=mesh)
    counts = run_steps(pipe, n_streams, steps)
    pipe.settle()
    own = n_streams // mesh.size()
    lo = mesh.get_local_rank() * own
    return {"counts": counts, "device": str(device),
            "backend": dist.get_backend(), "streams": (lo, lo + own),
            "launches": {k.name: k.launches for k in KERNELS}}


def main(argv=None):
    args = parse_args(__doc__, extra=lambda ap: (
        ap.add_argument("--steps", type=int, default=4),
        ap.add_argument("--streams", type=int, default=8),
        ap.add_argument("--ranks", type=int, default=None,
                        help="shard the streams over a world of this many "
                             "ranks (default: one device, no world)"),
    ), argv=argv)

    if args.ranks is None:
        from aicamera_tpu_torch.parallel import MultiStreamPipeline
        print(f"{args.streams} streams over one device ({args.device})")
        pipe = MultiStreamPipeline(n_streams=args.streams, frame_hw=HW,
                                   device=args.device)
        counts = run_steps(pipe, args.streams, args.steps)
    else:
        import torch
        from aicamera_tpu_torch.parallel.distributed import spawn
        # by this module's importable name, whether it runs as a script or
        # is imported: a spawned rank imports the function by that name
        from examples_torch.multistream import rank_main as fn
        cards = torch.cuda.device_count() if args.device.type == "cuda" else 0
        backend = "gloo" if args.ranks > cards else None
        results = spawn(fn, args.ranks, device=args.device, backend=backend,
                        args=(args.streams, args.steps), timeout=600.0)
        print(f"{args.streams} streams over a {args.ranks}-rank mesh "
              f"({results[0]['backend']})")
        for r, res in enumerate(results):
            lo, hi = res["streams"]
            print(f"rank {r} on {res['device']}: streams {lo}-{hi - 1}, "
                  f"kernel launches {res['launches']}")
        counts = results[0]["counts"]
    for t, c in enumerate(counts):
        print(f"step {t}: confirmed tracks per stream = {c}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
