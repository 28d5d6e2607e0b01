"""How far the port's RT-DETR-L lies from the plain f32 reference at the
published widths, on a batch of the ``rtdetrl720-bytetrack-8x4`` cell's
frames.

    python3 scripts/probe_rtdetr_gaps.py [--weights PATH] [--frames 32]

From the root of a checkout, on a machine with a CUDA card. The frames are
the cell's traffic (its eight fixed worlds, 1280x720), the first
``frames / 8`` of each. Both sides take the same letterboxed input (the
program's letterbox kernel in bf16, resp. the reference's letterbox in
f32). Prints one JSON line:

- ``encoder_logits``: the encoder's class logits over every anchor, the
  port (bf16, and f32 with TF32 off) against the reference (f32, TF32
  off): max and 99.9th percentile of the absolute gap, and the logits'
  largest magnitude;
- ``decoder``: the decoder teacher-forced (the reference's memory and its
  selected queries), the last layer's boxes and class probabilities;
- ``fp8``: the same gaps for the reference in float8 e4m3 (the control's
  precision), the scale a limit has to tell apart;
- ``top300_overlap``: the share of the reference's 300 selected anchors
  the bf16 port selects too;
- ``path``: ``MultiStreamPipeline(detector="rtdetr-l")`` over the cell's
  eight cameras, four dispatches after its capture, under CUDA's sync
  debug mode "error": replays, letterbox and NMS kernel launches, graph
  nodes, and whether any dispatch synchronized.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def gap(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float()).abs().flatten()
    return {"max": float(d.max()),
            "p999": float(torch.quantile(d[:2 ** 24], 0.999)),
            "scale": float(b.abs().max())}


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights",
                    default="models/detection/rtdetr_l_synthetic.msgpack")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only to rehearse the script")
    args = ap.parse_args(argv)
    from aicamera_tpu_torch.ops.letterbox import letterbox
    from aicamera_tpu_torch.ops.preprocess import letterbox_spec
    from aicamera_tpu_torch.runtime.params import resolve_rtdetr_params
    from portbench import harness
    from portbench.drivers import common
    from portbench.reference import msgpack_io
    from portbench.reference.letterbox import Letterbox
    from portbench.reference.rtdetr import RTDETRRef, tree_to_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, "rtdetrl720-bytetrack-8x4")
    _, traffic, _ = harness.cell_files(bench, cell)
    hw = tuple(traffic["frame_hw"])
    per = max(1, args.frames // 8)
    frames = np.concatenate([common.render_clip(traffic["world"], hw, per, i,
                                                dev) for i in range(8)])
    fr = torch.from_numpy(frames).to(dev)
    tree = msgpack_io.load_flax_msgpack(ROOT / args.weights)
    ref = RTDETRRef(tree_to_device(tree, dev))
    fp8 = RTDETRRef(tree_to_device(tree, dev), precision="fp8")
    x_ref = Letterbox(hw, (640, 640), dev)(fr)
    out = {"card": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "frames": len(frames)}

    def reference_side(net):
        feats, shapes = net.memory(net.encoder(*net.backbone(x_ref)))
        _, logits = net.encoder_scores(feats, shapes)
        return feats, shapes, logits

    rfeats, shapes, rlogits = reference_side(ref)
    embed, ref_logit, index = ref.select(rfeats, shapes)
    rboxes, rcls = ref.layers(embed, ref_logit, rfeats, shapes)
    spec = letterbox_spec(hw, (640, 640))
    dtypes = (("bf16", torch.bfloat16), ("f32", torch.float32)) \
        if dev.type == "cuda" else (("f32", torch.float32),)
    for name, dt in dtypes:
        port = resolve_rtdetr_params(args.weights, device=dev, dtype=dt)
        x = letterbox(fr, spec, dt)
        feats, pshapes = port.encode(port.features(x))
        top, pref, _, _, pindex, logits = port.decoder.select(feats, pshapes)
        row = {"encoder_logits": gap(logits, rlogits)}
        same = [len(set(a.tolist()) & set(b.tolist())) / len(a)
                for a, b in zip(pindex, index)]
        row["top300_overlap"] = float(np.mean(same))
        pembed, pref, *_ = port.decoder.select(rfeats.to(dt), shapes, index)
        boxes, cls = port.decoder.layers_forward(pembed, pref, rfeats.to(dt),
                                                 shapes)
        row["decoder"] = {"boxes": gap(boxes, rboxes),
                          "probs": gap(cls.float().sigmoid(),
                                       rcls.sigmoid())}
        out[name] = row
        del port
    _, _, f8logits = reference_side(fp8)
    f8boxes, f8cls = fp8.layers(*fp8.select(rfeats, shapes, index)[:2],
                                rfeats, shapes)
    out["fp8"] = {"encoder_logits": gap(f8logits, rlogits),
                  "decoder": {"boxes": gap(f8boxes, rboxes),
                              "probs": gap(f8cls.sigmoid(),
                                           rcls.sigmoid())}}
    out["path"] = path(args.weights, frames, hw, dev)
    print(json.dumps(out), flush=True)
    return 0


def path(weights, frames, hw, dev) -> dict:
    """The normal path's shape of a dispatch (see the module's
    docstring)."""
    from aicamera_tpu_torch.core.bytetrack import ByteTrackParams
    from aicamera_tpu_torch.ops import letterbox as lb_ops
    from aicamera_tpu_torch.ops import nms as nms_ops
    from aicamera_tpu_torch.parallel import MultiStreamPipeline
    pipe = MultiStreamPipeline(
        8, hw, detector="rtdetr-l", yolo_weights=weights,
        tracker="bytetrack", device=dev,
        bytetrack_params=ByteTrackParams(max_tracks=256, max_detections=100))
    batch = np.ascontiguousarray(frames.reshape(8, -1, *hw, 3)[:, :4])
    pipe.step_chunk(batch)
    torch.cuda.synchronize()
    lb0, nms0 = lb_ops.KERNEL.launches, nms_ops.KERNEL.launches
    r0 = pipe.step_replays()
    synced, outs = None, None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            outs = pipe.step_chunk(batch)
    except RuntimeError as e:
        synced = str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    steps = list(pipe._engine._steps.values())
    return {"replays": pipe.step_replays() - r0,
            "letterbox_launches": lb_ops.KERNEL.launches - lb0,
            "nms_launches": nms_ops.KERNEL.launches - nms0,
            "graph_nodes": [s.engine.graph_nodes() for s in steps],
            "sync": synced,
            "tracks": None if outs is None else int(outs[-1].sum())}


if __name__ == "__main__":
    sys.exit(main())
