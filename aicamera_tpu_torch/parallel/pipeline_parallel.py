"""Pipeline parallelism: the detector split into its three stages.

The port of ``aicamera_tpu/parallel/pipeline_parallel.py``. The detector's
natural stages (CSP backbone, PAN-FPN neck, decoupled head:
``models/yolov8.py``) run as separate modules, and microbatches stream
through them GPipe-style. Two modes:

- ``devices=``: one process, the usual PyTorch form of a naive pipeline.
  Stage k lives on ``devices[k % len(devices)]``; activations move with
  ``.to(device, non_blocking=True)`` and the host enqueues microbatch after
  microbatch without a sync, so stage k of microbatch i runs while stage
  k+1 of microbatch i-1 runs on the next card. One device is the
  degenerate case (the same three modules, no hops).
- ``meshes=``: SPMD over ``torch.distributed`` (every rank runs
  ``forward`` with the whole batch). Stage k runs on its own 2-D
  ``("stream", "model")`` mesh: the microbatch is split over ``stream``
  and the convolutions over ``model`` (:mod:`.tensor_parallel`). Between
  stages the activations move rank to rank in one batch of point-to-point
  sends and receives, re-split for the next mesh's stream size; after the
  head every rank receives the whole microbatch's outputs.

``forward`` returns the full model's per-level ``(box_bins, cls_logits)``,
which feed ``ops/nms.py::fused_decode_nms`` unchanged. Inference only.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..models.yolov8 import (REG_MAX, STRIDES, Backbone, DetectHead, Neck,
                             _widths)
from ..runtime.params import compute_dtype
from ..runtime.pipeline import precision
from .distributed import COLLECTIVES, rank_device

__all__ = ["PipelineParallelDetector", "split_stage_params"]

_STAGES = ("backbone", "neck", "head")


def split_stage_params(model: nn.Module):
    """A YOLOv8's state split into its stages' states ``(backbone, neck,
    head)``, each keyed as the stage module's own ``state_dict``. Together
    they hold every entry of ``model.state_dict()``."""
    parts = {k: {} for k in _STAGES}
    for key, value in model.state_dict().items():
        stage, rest = key.split(".", 1)
        parts[stage][rest] = value
    return tuple(parts[k] for k in _STAGES)


class PipelineParallelDetector:
    """Stage-split YOLOv8 forward over up to three devices, or over three
    stage meshes.

    Args:
        variant: YOLOv8 variant letter (n/s/m/l/x).
        devices: stage placement, one device per stage (backbone, neck,
            head); fewer than three cycle. Default: up to three CUDA
            devices (raises without a GPU).
        num_classes: the head's classes.
        dtype: the stages' dtype (default bf16 on the GPU, f32 on the CPU).
        meshes: the composed mode's stage meshes, each a 2-D ``("stream",
            "model")`` ``DeviceMesh``; fewer than three cycle. Every rank of
            the world constructs all of them and calls ``forward``.
    """

    def __init__(self, variant: str = "n",
                 devices: Optional[Sequence] = None,
                 num_classes: int = 80,
                 dtype: torch.dtype | None = None,
                 meshes: Optional[Sequence] = None):
        if meshes is not None:
            if devices is not None:
                raise ValueError("pass either devices or meshes, not both")
            meshes = list(meshes)
            if not meshes:
                raise ValueError("need at least one mesh")
            for m in meshes:
                names = tuple(m.mesh_dim_names or ())
                if set(names) != {"stream", "model"}:
                    raise ValueError(
                        "stage meshes must have axes ('stream', 'model'), "
                        f"got {names}")
            self.meshes = [meshes[i % len(meshes)] for i in range(3)]
            self.devices = [rank_device()] * 3
        else:
            self.meshes = None
            if devices is None:
                resolve_device(None)  # no GPU: raise
                devices = [torch.device("cuda", i) for i in
                           range(min(3, torch.cuda.device_count()))]
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ValueError("need at least one device")
            for d in devices:
                resolve_device(d)
            self.devices = [devices[i % len(devices)] for i in range(3)]
        self.variant = variant
        self.num_classes = num_classes
        self.dtype = dtype or compute_dtype(self.devices[0])
        self._stages = None

    def place_params(self, model: nn.Module) -> None:
        """Load each stage's part of ``model`` (a YOLOv8 of this variant)
        onto its device (one-time upload). In the composed mode each
        stage's convolutions are split over its mesh's ``model`` axis, and
        a rank holds only the stages whose mesh it is in."""
        from .tensor_parallel import shard_detector_params
        stages = []
        for k, state in enumerate(split_stage_params(model)):
            if self.meshes is not None \
                    and self.meshes[k].get_coordinate() is None:
                stages.append(None)
                continue
            mod = (Backbone(self.variant), Neck(self.variant),
                   DetectHead(self.variant, self.num_classes))[k]
            mod.load_state_dict(state)
            mod = mod.to(device=self.devices[k], dtype=self.dtype).eval()
            if self.meshes is not None:
                mod = shard_detector_params(mod, self.meshes[k])
            stages.append(mod)
        self._stages = stages
        if self.meshes is not None:
            # NCCL wants the first call on a group to involve all of its
            # ranks; a stage hop may not
            COLLECTIVES.barrier()

    def forward(self, frames: torch.Tensor, microbatch: int | None = None):
        """Run the detector over ``frames`` ``(B, 3, H, W)`` (NCHW in
        [0, 1], as the letterbox kernel writes them; H and W multiples of
        32), ``microbatch`` frames at a time (default: the largest size
        that keeps two in flight; in the composed mode also a multiple of
        every stage mesh's ``stream`` size). Returns the per-level
        ``(box_bins (B, h, w, 64), cls_logits (B, h, w, C))``, on the last
        stage's device (in the composed mode on every rank)."""
        if self._stages is None:
            raise RuntimeError("call place_params(model) first")
        b = frames.shape[0]
        stream_div = 1
        if self.meshes is not None:
            for m in self.meshes:
                stream_div = math.lcm(stream_div, _stream_size(m))
        if microbatch is None:
            if b % stream_div:
                raise ValueError(
                    f"batch {b} not divisible by the stage meshes' "
                    f"'stream' axis size(s) (lcm {stream_div}) — no "
                    "microbatch can shard it")
            mb = b
            for cand in range((b // 2) // stream_div * stream_div, 0,
                              -stream_div):
                if b % cand == 0:
                    mb = cand
                    break
        else:
            mb = microbatch
            if mb % stream_div:
                raise ValueError(
                    f"microbatch {mb} must be divisible by the stage "
                    f"meshes' 'stream' axis size(s) (lcm {stream_div}) — "
                    "each microbatch is batch-sharded over that axis")
        if b % mb:
            raise ValueError(f"batch {b} not divisible by microbatch {mb}")
        run = self._devices_microbatch if self.meshes is None \
            else self._composed_microbatch
        with torch.no_grad(), precision(self.dtype):
            outs = [run(frames[i:i + mb]) for i in range(0, b, mb)]
        if len(outs) == 1:
            return outs[0]
        return [tuple(torch.cat(parts, 0) for parts in zip(*levels))
                for levels in zip(*outs)]

    # --- devices= ------------------------------------------------------------

    def _devices_microbatch(self, x):
        back, neck, head = self._stages
        d0, d1, d2 = self.devices
        feats = back(x.to(d0, non_blocking=True).to(self.dtype))
        feats = neck(*(f.to(d1, non_blocking=True) for f in feats))
        return head([f.to(d2, non_blocking=True) for f in feats])

    # --- meshes= -------------------------------------------------------------

    def _composed_microbatch(self, x):
        mb, _, h, w = x.shape
        me = torch.distributed.get_rank()
        held = _rows_held(self.meshes[0], mb)
        feats = None
        if me in held:   # every rank holds the frames: no hop into stage 0
            lo, hi = held[me]
            feats = self._stages[0](
                x[lo:hi].to(self.devices[0], non_blocking=True)
                .to(self.dtype))
        for k in (1, 2):
            feats = self._hop(feats, k - 1, mb,
                              _rows_held(self.meshes[k], mb),
                              self._row_shapes(k - 1, h, w))
            if feats is not None and k == 1:
                feats = self._stages[1](*feats)
            elif feats is not None:   # the head's levels, flattened
                feats = [t for pair in self._stages[2](list(feats))
                         for t in pair]
        world = torch.distributed.get_world_size()
        feats = self._hop(feats, 2, mb, {r: (0, mb) for r in range(world)},
                          self._row_shapes(2, h, w))
        return [(feats[2 * i], feats[2 * i + 1]) for i in range(3)]

    def _row_shapes(self, k: int, h: int, w: int):
        """Per-row shapes of stage k's outputs (flattened for the head)."""
        _, ch = _widths(self.variant)
        grids = [(h // s, w // s) for s in STRIDES]
        if k < 2:   # backbone and neck: NCHW at channels ch[2], ch[3], ch[4]
            return [(c, gh, gw) for c, (gh, gw) in zip(ch[2:], grids)]
        return [shape for (gh, gw) in grids
                for shape in ((gh, gw, 4 * REG_MAX),
                              (gh, gw, self.num_classes))]

    def _hop(self, tensors, k: int, mb: int, want: dict, row_shapes):
        """Move stage k's outputs (held per ``_rows_held(meshes[k], mb)``)
        to the ranks of ``want`` (rank -> rows it needs), in one batch of
        point-to-point sends and receives; rows a rank holds itself are
        sliced locally. Returns this rank's rows, or None."""
        me = torch.distributed.get_rank()
        dist = torch.distributed
        held = _rows_held(self.meshes[k], mb)
        blocks = sorted({v: [r for r in held if held[r] == v]
                         for v in held.values()}.items())
        dev, per_row = self.devices[0], [math.prod(s) for s in row_shapes]
        ops, recvs, local = [], [], []
        for dst in sorted(want):
            lo, hi = want[dst]
            for (b_lo, b_hi), holders in blocks:
                a, z = max(lo, b_lo), min(hi, b_hi)
                if a >= z:
                    continue
                src = dst if dst in holders else \
                    holders[dst % len(holders)]
                if src == me and dst == me:
                    local.append((a, [t[a - b_lo:z - b_lo]
                                      for t in tensors]))
                elif src == me:
                    buf = torch.cat([t[a - b_lo:z - b_lo].reshape(-1)
                                     for t in tensors])
                    ops.append(dist.P2POp(dist.isend, buf, dst))
                elif dst == me:
                    buf = torch.empty((z - a) * sum(per_row),
                                      dtype=self.dtype, device=dev)
                    ops.append(dist.P2POp(dist.irecv, buf, src))
                    recvs.append((a, z, buf))
        if ops:
            COLLECTIVES.batch_isend_irecv(ops)
        if me not in want:
            return None
        for a, z, buf in recvs:
            parts = torch.split(buf, [(z - a) * n for n in per_row])
            local.append((a, [p.view(z - a, *s)
                              for p, s in zip(parts, row_shapes)]))
        local.sort(key=lambda t: t[0])
        return [torch.cat([rows[i] for _, rows in local])
                for i in range(len(row_shapes))]


def _stream_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("stream"))


def _rows_held(mesh, mb: int) -> dict:
    """rank -> (lo, hi): the microbatch rows each rank of a stage mesh
    computes (its stream block; every model rank of it alike)."""
    names = mesh.mesh_dim_names
    ranks = mesh.mesh.permute(names.index("stream"), names.index("model"))
    q = mb // ranks.shape[0]
    return {int(r): (s * q, (s + 1) * q)
            for s in range(ranks.shape[0]) for r in ranks[s].tolist()}
