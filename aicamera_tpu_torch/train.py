"""Training on the card: the synthetic-world detector, the ReID embedder and
the clip fine-tune.

The port of ``aicamera_tpu/train.py``. The models are the inference modules
(:mod:`.models.yolov8`, :mod:`.models.reid`); scenes are rendered on the
device from PRNG keys (:mod:`.synthetic`), so there is no host-to-device
training data. Every key is split as the JAX package splits it, so each
training scene is the JAX package's scene bit for bit.

Where the JAX trainer jits ``lax.scan`` over ``cfg.scan`` steps, a dispatch
here is a Python loop of ``cfg.scan`` steps whose losses stay on the device
and are read once, at the dispatch's end (``TRAIN_SYNCS`` counts the
reads). A step renders its B frames and letterboxes them in one launch of
the letterbox kernel (``ops.letterbox.letterbox``; the clip step makes two:
clip frames, then synthetic ones).

Mixed precision follows the Flax modules (``param_dtype`` f32, ``dtype``
bf16): the module holds f32 master weights; each forward runs on a bf16 copy
of them on the card (f32 on the CPU), and the gradients reach the f32
weights through the cast. The optimizer is optax's
``chain(clip_by_global_norm(10), adamw(warmup_cosine_decay_schedule(...)))``
written out: the first update runs at learning rate 0, the cosine horizon
counts the warm-up steps, and weight decay reaches the biases.

Assignment (one positive anchor per ground-truth box, at the FPN level its
size selects) and the losses (BCE, distribution-focal, IoU; bidirectional
InfoNCE for the embedder) are the JAX package's.

:func:`make_train_step_dp` is the data-parallel detector step over a
``DeviceMesh`` axis, one process a rank (``parallel.distributed``): each
rank renders its block of the step's scenes, and one all-reduce a step
averages the gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import prng
from .prng import _f32
from .device import resolve_device
from .models.yolov8 import REG_MAX, STRIDES
from .ops.crops import extract_reid_crops
from .ops.letterbox import letterbox
from .ops.preprocess import LetterboxSpec, letterbox_spec
from .runtime.params import compute_dtype, seeded_init_
from .runtime.pipeline import precision
from .synthetic import WorldSpec, ground_truth, random_objects, render
from .syncs import SyncCounter

# FPN level selection thresholds on max(w, h) in letterbox pixels. The
# center-cell DFL reach at level l is REG_MAX * stride_l per side, so each
# threshold keeps targets comfortably inside the bin range.
_LEVEL_MAX_SIZE = (80.0, 160.0)

# The stages a step marks on a ``runtime.pipeline.CudaStageTimer``.
# (The detector marks no "crops", the embedder no "letterbox".)
TRAIN_STAGES = ("render", "letterbox", "crops", "forward", "backward",
                "optimizer")

TRAIN_SYNCS = SyncCounter()  # the losses' read: one per dispatch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch: int = 8
    steps: int = 3000
    scan: int = 25                  # optimizer steps per dispatch
    lr: float = 2e-3
    warmup: int = 200
    weight_decay: float = 1e-5
    w_cls: float = 1.0
    w_iou: float = 2.5
    w_dfl: float = 0.4
    seed: int = 0


# --- optimizer: optax's chain, written out --------------------------------

def warmup_cosine_schedule(peak: float, warmup: int, decay_steps: int,
                           end: float):
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps,
    end)`` as a host function of the step count, in float32 operation by
    operation (the warm-up's ``(0 - peak) * frac + peak`` cancels, so a
    float64 version differs from optax's in the fifth digit)."""
    one, half = np.float32(1.0), np.float32(0.5)
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = one - np.float32(min(max(count, 0), warmup)) / np.float32(
                warmup)
            return float(np.float32(0.0 - peak) * frac + np.float32(peak))
        c = np.float32(min(count - warmup, decay_steps - warmup))
        cos = half * (one + np.cos(np.float32(np.pi) * c
                                   / np.float32(decay_steps - warmup)))
        return float(np.float32(peak) * (np.float32(1 - alpha) * cos
                                         + np.float32(alpha)))

    return schedule


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``, in place: every gradient times
    ``max_norm / ||g||`` when the global norm reaches ``max_norm``, else
    unchanged (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and
    always scales). Returns the norm, on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay=...))`` over a module's parameters, updating them in place
    with optax's operations in optax's order (``torch.optim.AdamW`` folds
    the decay and the bias corrections differently: a few ulps a step).
    The learning rate comes from the host schedule, starting at count 0;
    nothing is read back from the device."""

    def __init__(self, params, schedule, weight_decay: float,
                 max_norm: float = 10.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = [p for p in params]
        self.schedule = schedule
        self.weight_decay = _f32(weight_decay)
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, _f32(eps)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad``."""
        grads = [p.grad for p in self.params]
        clip_by_global_norm_(grads, self.max_norm)
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, _f32(b1))
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, _f32(1 - b1)))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, _f32(1 - b2))
        torch._foreach_mul_(self.nu, _f32(b2))
        torch._foreach_add_(self.nu, g2)
        n = self.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -self.schedule(self.count))
        torch._foreach_add_(self.params, upd)
        self.count = n


def make_optimizer(model: torch.nn.Module, lr: float, warmup: int,
                   total_steps: int, weight_decay: float) -> AdamW:
    """The JAX trainers' optimizer for ``total_steps`` steps:
    ``warmup_cosine_decay_schedule(0, lr, warmup, max(total_steps,
    warmup + 1), lr / 20)`` under AdamW with a global-norm clip of 10."""
    sched = warmup_cosine_schedule(lr, warmup, max(total_steps, warmup + 1),
                                   lr / 20)
    return AdamW(model.parameters(), sched, weight_decay)


def _dispatches(steps: int, scan: int, log, what: str = "steps"):
    """Dispatch count and trained steps: ``steps`` rounded up to a multiple
    of ``scan`` (the schedule's horizon is the rounded count)."""
    n_disp = max(1, -(-steps // scan))
    total = n_disp * scan
    if total != steps:
        log(f"{what} rounded {steps} -> {total} (scan={scan} per dispatch)")
    return n_disp, total


def _read(losses: torch.Tensor, auxes: dict):
    """The dispatch's losses and aux terms to the host in one read."""
    rows = TRAIN_SYNCS.tolist(torch.stack([losses, *auxes.values()]))
    return np.asarray(rows[0]), {k: np.asarray(r)
                                 for k, r in zip(auxes, rows[1:])}


def _forward(model: torch.nn.Module, x: torch.Tensor, dtype: torch.dtype):
    """``model(x)`` on a ``dtype`` copy of its (f32) weights; gradients
    reach the f32 weights through the cast."""
    if dtype == torch.float32:
        return model(x)
    params = {k: v.to(dtype) for k, v in model.named_parameters()}
    return torch.func.functional_call(model, params, (x,))


def _precision(dtype: torch.dtype, device: torch.device):
    """The context of a forward and backward: on the card
    ``runtime.pipeline.precision`` (TF32 off in f32); on the CPU PyTorch's
    own convolutions in place of oneDNN's, whose f32 weight gradients lose
    accuracy where the per-position terms nearly cancel (the ReID net's
    last-layer biases, behind the L2 norm: 4% off a float64 reference,
    where PyTorch's own and XLA's are within 1e-5)."""
    return _without_onednn() if device.type == "cpu" else precision(dtype)


@contextlib.contextmanager
def _without_onednn():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


def _mark(timer, stage: str):
    if timer is not None:
        timer.mark(stage)


# --- detector: targets and loss ---------------------------------------------

def _level_tables(input_hw: Tuple[int, int]):
    """Static per-level (H, W, base anchor offset) tables."""
    lh = [(input_hw[0] // s, input_hw[1] // s) for s in STRIDES]
    bases, b = [], 0
    for (h, w) in lh:
        bases.append(b)
        b += h * w
    return lh, bases, b


def _level_table(values, level: torch.Tensor, dtype) -> torch.Tensor:
    """``values[level]`` for a 3-entry static table, built from scalars (no
    upload)."""
    return torch.where(level == 0, values[0],
                       torch.where(level == 1, values[1],
                                   values[2])).to(dtype)


def build_targets(gt_xyxy, gt_cls, gt_valid, spec: LetterboxSpec,
                  input_hw: Tuple[int, int], num_classes: int = 80):
    """Dense targets from source-pixel ground truth, for ``(N, 4)`` boxes of
    one image or ``(B, N, 4)`` of B.

    Returns ``(cls_t (..., A, C), box_t (..., A, 4) ltrb in stride units,
    pos (..., A))``. One positive anchor per gt: the center cell at the
    size-selected level. Anchor collisions resolve as on the JAX package's
    CPU backend: the class targets by max (order-free) and the box target
    by the last write, i.e. the highest gt index wins, chosen here
    explicitly (a scatter with duplicate indices is nondeterministic on
    CUDA). Invalid gts scatter to a dump row that is sliced off.
    """
    single = gt_xyxy.dim() == 2
    if single:
        gt_xyxy, gt_cls, gt_valid = gt_xyxy[None], gt_cls[None], gt_valid[None]
    lh, bases, a_total = _level_tables(input_hw)
    r, left, top = _f32(spec.ratio), float(spec.left), float(spec.top)
    # source -> letterbox coords
    x1 = gt_xyxy[..., 0] * r + left
    y1 = gt_xyxy[..., 1] * r + top
    x2 = gt_xyxy[..., 2] * r + left
    y2 = gt_xyxy[..., 3] * r + top
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    size = torch.maximum(x2 - x1, y2 - y1)
    level = ((size > _LEVEL_MAX_SIZE[0]).to(torch.int32)
             + (size > _LEVEL_MAX_SIZE[1]).to(torch.int32))

    strides = _level_table(STRIDES, level, torch.float32)
    lw = _level_table([w for (_, w) in lh], level, torch.int32)
    lhh = _level_table([h for (h, _) in lh], level, torch.int32)
    base = _level_table(bases, level, torch.int32)
    ci = torch.minimum(torch.clamp_min((cx / strides).to(torch.int32), 0),
                       lw - 1)
    cj = torch.minimum(torch.clamp_min((cy / strides).to(torch.int32), 0),
                       lhh - 1)
    anchor = base + cj * lw + ci
    # centers of the chosen cells, letterbox pixels
    acx = (ci.float() + 0.5) * strides
    acy = (cj.float() + 0.5) * strides
    ltrb = torch.stack([acx - x1, acy - y1, x2 - acx, y2 - acy],
                       dim=-1) / strides[..., None]
    ltrb = torch.clamp(ltrb, 0.0, _f32(REG_MAX - 1.01))

    ok = gt_valid & (x2 > x1 + 1) & (y2 > y1 + 1)
    tgt = torch.where(ok, anchor, a_total).long()              # (B, N)
    b, n = tgt.shape
    idx = torch.arange(n, device=tgt.device)
    later_same = ((tgt[:, None, :] == tgt[:, :, None])
                  & (idx[None, :] > idx[:, None]))              # (B, N, N)
    box_tgt = torch.where(later_same.any(-1), a_total, tgt)
    row0 = (torch.arange(b, device=tgt.device) * (a_total + 1))[:, None]
    rows, box_rows = (row0 + tgt).reshape(-1), (row0 + box_tgt).reshape(-1)

    dev = gt_xyxy.device
    cls_t = torch.zeros(b * (a_total + 1), num_classes, device=dev)
    cls_t.index_put_((rows, gt_cls.reshape(-1).long()),
                     torch.ones((), device=dev))
    box_t = torch.zeros(b * (a_total + 1), 4, device=dev)
    box_t.index_put_((box_rows,), ltrb.reshape(-1, 4))
    pos = torch.zeros(b * (a_total + 1), dtype=torch.bool, device=dev)
    pos.index_put_((rows,), ok.reshape(-1))
    out = (cls_t.view(b, a_total + 1, -1)[:, :a_total],
           box_t.view(b, a_total + 1, 4)[:, :a_total],
           pos.view(b, a_total + 1)[:, :a_total])
    return tuple(t[0] for t in out) if single else out


def detection_loss(level_outputs, cls_t, box_t, pos, cfg: TrainConfig):
    """Per-image losses ``(B,)`` and their parts from raw head outputs
    (per level ``(box_bins (B, h, w, 64), cls_logits (B, h, w, C))``) and
    batched dense targets. Where the JAX package takes ``jnp.maximum`` or
    ``jnp.minimum`` of a value with a gradient, this takes
    ``torch.maximum``/``torch.minimum``: both split the gradient evenly at
    a tie, where ``clamp`` passes it whole."""
    nbins = 4 * REG_MAX
    bsz = cls_t.shape[0]
    bins = torch.cat([bb.reshape(bsz, -1, nbins) for bb, _ in level_outputs],
                     dim=1)
    logits = torch.cat([cl.reshape(bsz, -1, cl.shape[-1])
                        for _, cl in level_outputs], dim=1).float()

    npos = torch.clamp_min(pos.float().sum(-1), 1.0)           # (B,)
    # optax.sigmoid_binary_cross_entropy
    bce = (-cls_t * F.logsigmoid(logits)
           - (1.0 - cls_t) * F.logsigmoid(-logits))
    loss_cls = bce.sum((1, 2)) / npos

    b = bins.float().reshape(bsz, -1, 4, REG_MAX)
    logp = torch.log_softmax(b, dim=-1)
    lo = torch.floor(box_t).long()
    hi = torch.clamp_max(lo + 1, REG_MAX - 1)
    wl = hi.float() - box_t
    wr = 1.0 - wl
    ce = -(wl * torch.gather(logp, -1, lo[..., None])[..., 0]
           + wr * torch.gather(logp, -1, hi[..., None])[..., 0])
    zero = torch.zeros((), device=ce.device)
    loss_dfl = torch.where(pos[..., None], ce, zero).sum((1, 2)) / npos

    bin_idx = torch.arange(REG_MAX, dtype=torch.float32, device=b.device)
    dist = (torch.softmax(b, dim=-1) * bin_idx).sum(-1)        # (B, A, 4)
    # IoU of predicted vs target ltrb around the same center (stride units)
    iw = (torch.minimum(dist[..., 0], box_t[..., 0])
          + torch.minimum(dist[..., 2], box_t[..., 2]))
    ih = (torch.minimum(dist[..., 1], box_t[..., 1])
          + torch.minimum(dist[..., 3], box_t[..., 3]))
    inter = torch.maximum(iw, zero) * torch.maximum(ih, zero)
    area_p = (torch.maximum(dist[..., 0] + dist[..., 2], zero)
              * torch.maximum(dist[..., 1] + dist[..., 3], zero))
    area_t = ((box_t[..., 0] + box_t[..., 2])
              * (box_t[..., 1] + box_t[..., 3]))
    iou = inter / torch.maximum(area_p + area_t - inter,
                                torch.full((), 1e-7, device=ce.device))
    loss_iou = torch.where(pos, 1.0 - iou, zero).sum(-1) / npos

    return (cfg.w_cls * loss_cls + cfg.w_iou * loss_iou
            + cfg.w_dfl * loss_dfl,
            {"cls": loss_cls, "iou": loss_iou, "dfl": loss_dfl})


def _render_batch(keys, world: WorldSpec, device):
    """One scene per key (``split`` into objects and render keys, as the JAX
    trainers split): frames ``(B, H, W, 3)`` u8 and their ground truth."""
    frames, gts = [], []
    for k in keys:
        ko, kr = prng.split(k)
        obj = random_objects(ko, world, device)
        frames.append(render(obj, world, kr))
        gts.append(ground_truth(obj, world))
    boxes, cls, valid = (torch.stack(t) for t in zip(*gts))
    return torch.stack(frames), boxes, cls, valid


def _optimizer_step(loss, tx: AdamW, timer):
    tx.zero_grad()
    loss.backward()
    _mark(timer, "backward")
    tx.step()
    _mark(timer, "optimizer")


def _stack_aux(auxes):
    return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


def make_train_step(model, world: WorldSpec, spec: LetterboxSpec,
                    input_hw: Tuple[int, int], cfg: TrainConfig, tx: AdamW,
                    dtype: torch.dtype | None = None, stage_timer=None):
    """The detector's dispatch: ``multi_step(key) -> (losses (scan,),
    auxes)`` on the device, ``cfg.scan`` optimizer steps on scenes rendered
    on the device, updating ``model`` (f32) and ``tx`` in place.
    ``dtype``: the forward's (default bf16 on the GPU, f32 on the CPU; f32
    runs with TF32 off). ``stage_timer``: a ``CudaStageTimer`` over
    ``TRAIN_STAGES`` whose marks the steps record."""
    device = next(model.parameters()).device
    dtype = dtype or compute_dtype(device)

    def one_step(key):
        frames, gt_xyxy, gt_cls, gt_valid = _render_batch(
            prng.split(key, cfg.batch), world, device)
        _mark(stage_timer, "render")
        x = letterbox(frames, spec, dtype)
        _mark(stage_timer, "letterbox")
        cls_t, box_t, pos = build_targets(gt_xyxy, gt_cls, gt_valid, spec,
                                          input_hw)
        with _precision(dtype, device):
            loss, aux = detection_loss(_forward(model, x, dtype), cls_t,
                                       box_t, pos, cfg)
            loss = loss.mean()
            _mark(stage_timer, "forward")
            _optimizer_step(loss, tx, stage_timer)
        return loss.detach(), {k: v.detach().mean() for k, v in aux.items()}

    def multi_step(key):
        if stage_timer is not None:
            stage_timer.start()
        losses, auxes = zip(*[one_step(k) for k in prng.split(key, cfg.scan)])
        return torch.stack(losses), _stack_aux(auxes)

    return multi_step


# --- ReID -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReIDTrainConfig:
    scenes: int = 4                 # scenes per step (each x2 views)
    steps: int = 2500
    scan: int = 25
    lr: float = 1e-3
    warmup: int = 100
    weight_decay: float = 1e-5
    temperature: float = 0.1
    jitter: float = 0.06            # box jitter fraction of extent
    erase_max: float = 0.5          # max occluder fraction per crop axis
    photometric: float = 0.15       # brightness/contrast jitter span
    seed: int = 0


def reid_contrastive_loss(za, zb, valid, temperature: float):
    """Bidirectional InfoNCE over two views of M instances: ``za, zb`` are
    L2-normalized ``(M, D)`` embeddings of the same instances under
    different rendering and crop noise; ``valid`` masks empty slots; every
    other valid instance is a negative."""
    sim = (za @ zb.T) / temperature                  # (M, M)
    neg_inf = torch.full((), -1e9, dtype=sim.dtype, device=sim.device)
    sim = torch.where(valid[None, :], sim, neg_inf)
    sim_t = torch.where(valid[:, None], sim, neg_inf)
    ce_ab = -torch.diagonal(torch.log_softmax(sim, dim=1))
    ce_ba = -torch.diagonal(torch.log_softmax(sim_t, dim=0))
    n = torch.clamp_min(valid.float().sum(), 1.0)
    zero = torch.zeros((), dtype=sim.dtype, device=sim.device)
    return torch.where(valid, ce_ab + ce_ba, zero).sum() / (2.0 * n)


def _random_erase(keys, crops, erase_max: float):
    """Occlude a random rectangle per crop (fill 0, the ImageNet mean after
    normalization), one key per scene: ``crops`` ``(S, N, h, w, 3)``.
    Tracking's hard failure is a crossing object corrupting the crop, so
    the positive pairs must survive partial occlusion."""
    s, n, ch, cw = crops.shape[:4]
    dev = crops.device
    ctr, size = [], []
    for k in keys:
        kc, ks = prng.split(k)
        ctr.append(prng.uniform(kc, (n, 2), device=dev))
        size.append(prng.uniform(ks, (n, 2), 0.1, erase_max, device=dev))
    ctr, size = torch.stack(ctr), torch.stack(size)            # (S, N, 2)
    yy = torch.arange(ch, dtype=torch.float32, device=dev) / ch
    xx = torch.arange(cw, dtype=torch.float32, device=dev) / cw
    in_y = torch.abs(yy - ctr[..., :1]) < size[..., :1] / 2     # (S, N, ch)
    in_x = torch.abs(xx - ctr[..., 1:]) < size[..., 1:] / 2     # (S, N, cw)
    hole = in_y[..., :, None] & in_x[..., None, :]
    return torch.where(hole[..., None], torch.zeros((), dtype=crops.dtype,
                                                    device=dev), crops)


def _photometric(keys, crops, span: float):
    """Per-crop brightness/contrast jitter on normalized values, one key
    per scene."""
    n = crops.shape[1]
    gain, bias = [], []
    for k in keys:
        kg, kb = prng.split(k)
        gain.append(1.0 + prng.uniform(kg, (n, 1, 1, 1), -span, span,
                                       device=crops.device))
        bias.append(prng.uniform(kb, (n, 1, 1, 1), -span, span,
                                 device=crops.device))
    gain, bias = torch.stack(gain), torch.stack(bias)
    return crops * gain.to(crops.dtype) + bias.to(crops.dtype)


def make_reid_train_step(model, world: WorldSpec, cfg: ReIDTrainConfig,
                         tx: AdamW, dtype: torch.dtype | None = None,
                         stage_timer=None):
    """The ReID dispatch, ``multi_step(key) -> losses (scan,)``: per step
    each scene is rendered twice (other background and noise), its gt
    crops are gathered with the production crop extractor (the second
    view's boxes jittered, then erased and photometrically jittered), and
    InfoNCE pulls the view pairs together."""
    device = next(model.parameters()).device
    dtype = dtype or compute_dtype(device)
    jitter = _f32(cfg.jitter)

    def one_step(key):
        fa, fb, boxes, jit_b, valid, ke, kp = [], [], [], [], [], [], []
        for k in prng.split(key, cfg.scenes):
            ko, ka, kb, kj, k_e, k_p = prng.split(k, 6)
            obj = random_objects(ko, world, device)
            bx, _, v = ground_truth(obj, world)
            fa.append(render(obj, world, ka))
            fb.append(render(obj, world, kb))
            w, h = bx[:, 2] - bx[:, 0], bx[:, 3] - bx[:, 1]
            ext = torch.stack([w, h, w, h], dim=-1)
            jit_b.append(bx + jitter * ext * prng.normal(kj, bx.shape,
                                                         device))
            boxes.append(bx)
            valid.append(v)
            ke.append(k_e)
            kp.append(k_p)
        _mark(stage_timer, "render")
        ca, va = extract_reid_crops(torch.stack(fa), torch.stack(boxes),
                                    compute_dtype=dtype)
        cb, vb = extract_reid_crops(torch.stack(fb), torch.stack(jit_b),
                                    compute_dtype=dtype)
        cb = _photometric(kp, _random_erase(ke, cb, cfg.erase_max),
                          cfg.photometric)
        valid = torch.stack(valid) & va & vb
        m = cfg.scenes * world.max_objects
        _mark(stage_timer, "crops")
        with _precision(dtype, device):
            za = _forward(model, ca.reshape(m, *ca.shape[2:]), dtype).float()
            zb = _forward(model, cb.reshape(m, *cb.shape[2:]), dtype).float()
            loss = reid_contrastive_loss(za, zb, valid.reshape(m),
                                         cfg.temperature)
            _mark(stage_timer, "forward")
            _optimizer_step(loss, tx, stage_timer)
        return loss.detach()

    def multi_step(key):
        if stage_timer is not None:
            stage_timer.start()
        return torch.stack([one_step(k) for k in prng.split(key, cfg.scan)])

    return multi_step


# --- clip fine-tune ---------------------------------------------------------

def make_clip_train_step(model, spec: LetterboxSpec,
                         input_hw: Tuple[int, int], cfg: TrainConfig,
                         tx: AdamW, synthetic_world: WorldSpec | None = None,
                         synthetic_frac: float = 0.5,
                         dtype: torch.dtype | None = None, stage_timer=None):
    """Self-training dispatch over a labelled clip,
    ``multi_step(key, frames, boxes, cls, valid) -> (losses, auxes)``, the
    clip's tensors on the model's device.

    Each batch image is a uniformly drawn clip frame with its labels,
    flipped horizontally at random and jittered in gain and bias, or, for
    ``synthetic_frac`` of the batch, a freshly rendered synthetic scene,
    so the adapted detector keeps its synthetic-world competence. Two
    letterbox launches a step: the clip images, then the synthetic ones.
    """
    device = next(model.parameters()).device
    dtype = dtype or compute_dtype(device)
    syn_spec = (letterbox_spec(synthetic_world.hw, input_hw)
                if synthetic_world is not None else None)
    n_syn = (int(round(cfg.batch * synthetic_frac))
             if synthetic_world is not None else 0)
    n_clip = cfg.batch - n_syn

    def clip_images(keys, frames, boxes, cls, valid):
        n_frames, w_src = frames.shape[0], float(frames.shape[2])
        idx, flip, gain, bias = [], [], [], []
        for k in keys:
            ki, kf, kb, kc = prng.split(k, 4)
            idx.append(prng.randint(ki, (), 0, n_frames, device))
            flip.append(prng.bernoulli(kf, 0.5, (), device))
            gain.append(1.0 + _f32(0.15) * prng.uniform(kb, (), -1.0, 1.0,
                                                        device))
            bias.append(_f32(12.0) * prng.uniform(kc, (), -1.0, 1.0, device))
        idx = torch.stack(idx).long()
        flip = torch.stack(flip)
        gain, bias = torch.stack(gain), torch.stack(bias)
        img = frames.index_select(0, idx).float()
        b = boxes.index_select(0, idx)
        # horizontal flip (labels mirrored)
        fb = torch.stack([w_src - b[..., 2], b[..., 1],
                          w_src - b[..., 0], b[..., 3]], dim=-1)
        img = torch.where(flip[:, None, None, None], img.flip(2), img)
        b = torch.where(flip[:, None, None], fb, b)
        # photometric jitter: gain/bias well inside what the letterbox's
        # /255 normalization sees at inference
        img = torch.clamp(img * gain[:, None, None, None]
                          + bias[:, None, None, None], 0.0, 255.0)
        return (img.to(torch.uint8).contiguous(), b,
                cls.index_select(0, idx), valid.index_select(0, idx))

    def one_step(key, frames, boxes, cls, valid):
        kc, ks = prng.split(key)
        img, b, c, v = clip_images(prng.split(kc, n_clip), frames, boxes,
                                   cls, valid)
        parts = [(img, b, c, v, spec)]
        if n_syn:
            parts.append((*_render_batch(prng.split(ks, n_syn),
                                         synthetic_world, device), syn_spec))
        _mark(stage_timer, "render")
        x = torch.cat([letterbox(p[0], p[4], dtype) for p in parts])
        _mark(stage_timer, "letterbox")
        targets = [build_targets(p[1], p[2], p[3], p[4], input_hw)
                   for p in parts]
        cls_t, box_t, pos = (torch.cat(t) for t in zip(*targets))
        with _precision(dtype, device):
            per_image, aux = detection_loss(_forward(model, x, dtype), cls_t,
                                            box_t, pos, cfg)
            # the JAX package sums the clip part, then the synthetic part
            loss = (per_image[:n_clip].sum()
                    + per_image[n_clip:].sum()) / cfg.batch
            _mark(stage_timer, "forward")
            _optimizer_step(loss, tx, stage_timer)
        return loss.detach(), {
            k: (v[:n_clip].sum() + v[n_clip:].sum()).detach() / cfg.batch
            for k, v in aux.items()}

    def multi_step(key, frames, boxes, cls, valid):
        if stage_timer is not None:
            stage_timer.start()
        losses, auxes = zip(*[one_step(k, frames, boxes, cls, valid)
                              for k in prng.split(key, cfg.scan)])
        return torch.stack(losses), _stack_aux(auxes)

    return multi_step


def make_train_step_dp(model, world: WorldSpec, spec: LetterboxSpec,
                       input_hw: Tuple[int, int], cfg: TrainConfig,
                       tx: AdamW, mesh, axis: str = "batch",
                       dtype: torch.dtype | None = None, stage_timer=None):
    """Data-parallel :func:`make_train_step` over ``mesh``'s ``axis``, one
    process a rank (``parallel.distributed``), same contract: a dispatch
    ``multi_step(key) -> (losses (scan,), auxes)`` with the global batch
    means, on every rank.

    Each step splits its key into ``cfg.batch`` scene keys, as JAX's does,
    and this rank takes its contiguous block of ``cfg.batch / n`` (what
    ``P(axis)`` gives device r): it renders those scenes on its device,
    letterboxes them in one launch, and runs forward and backward on them.
    One all-reduce a step over the axis then sums the gradients of the
    ranks' per-image loss sums and the loss parts (one flat buffer); the
    sums over the global batch are divided by ``cfg.batch``. Every rank
    applies the same clipped AdamW update to the same gradients, so the
    parameters and the optimizer state stay replicated (rank 0's parameters
    are broadcast once, here, so that they also start so). The all-reduce
    is timed under the ``backward`` mark."""
    from .parallel.distributed import COLLECTIVES
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (axes {names})")
    n_shard = mesh.size(names.index(axis))
    if cfg.batch % n_shard:
        raise ValueError(
            f"cfg.batch={cfg.batch} not divisible by mesh axis "
            f"'{axis}' size {n_shard}")
    device = next(model.parameters()).device
    dtype = dtype or compute_dtype(device)
    group = mesh.get_group(axis)
    b_local = cfg.batch // n_shard
    lo = mesh.get_local_rank(axis) * b_local
    params = list(model.parameters())
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params])
        COLLECTIVES.broadcast(flat, torch.distributed.get_global_rank(
            group, 0), group=group)
        torch._foreach_copy_(params, _unflatten(flat, params))

    def one_step(key):
        keys = prng.split(key, cfg.batch)[lo:lo + b_local]
        frames, gt_xyxy, gt_cls, gt_valid = _render_batch(keys, world,
                                                          device)
        _mark(stage_timer, "render")
        x = letterbox(frames, spec, dtype)
        _mark(stage_timer, "letterbox")
        cls_t, box_t, pos = build_targets(gt_xyxy, gt_cls, gt_valid, spec,
                                          input_hw)
        with _precision(dtype, device):
            loss, aux = detection_loss(_forward(model, x, dtype), cls_t,
                                       box_t, pos, cfg)
            sums = torch.stack([loss.sum(), *(v.sum() for v in aux.values())])
            _mark(stage_timer, "forward")
            tx.zero_grad()
            sums[0].backward()
        # the one collective of a step: gradients and loss parts, summed
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in params]
                         + [sums.detach()])
        COLLECTIVES.all_reduce(flat, group=group)
        flat = flat / torch.full((), cfg.batch, dtype=flat.dtype,
                                 device=flat.device)
        for p, g in zip(params, _unflatten(flat, params)):
            p.grad = g
        _mark(stage_timer, "backward")
        tx.step()
        _mark(stage_timer, "optimizer")
        means = flat[-len(sums):]
        return means[0], dict(zip(aux, means[1:]))

    def multi_step(key):
        if stage_timer is not None:
            stage_timer.start()
        losses, auxes = zip(*[one_step(k) for k in prng.split(key, cfg.scan)])
        return torch.stack(losses), _stack_aux(auxes)

    return multi_step


def _unflatten(flat: torch.Tensor, like):
    """Views of ``flat`` shaped as the tensors of ``like``, in order."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


# --- entry points -----------------------------------------------------------

def _new_model(model, make, device):
    """The module to train: ``model`` (its weights taken as the start) or a
    fresh one with the port's seeded init, as f32 on ``device``."""
    if model is None:
        model = make()
        seeded_init_(model)
    return model.to(device=device, dtype=torch.float32).train()


def finetune_on_clip(frames: np.ndarray, boxes: np.ndarray,
                     cls: np.ndarray, valid: np.ndarray, model,
                     input_hw: Tuple[int, int] = (640, 640),
                     cfg: TrainConfig = TrainConfig(steps=1500, lr=5e-4),
                     synthetic_world: WorldSpec | None = WorldSpec(),
                     synthetic_frac: float = 0.5, log=print, device=None):
    """Fine-tune a detector (``model``, e.g. from ``resolve_yolo_params``)
    on a labelled clip; returns the f32 model, trained in place on
    ``device`` (default the GPU; raises without one). ``frames`` (F, H, W,
    3) u8; ``boxes`` (F, M, 4) xyxy source pixels; ``cls`` (F, M) COCO ids;
    ``valid`` (F, M) bool."""
    device = resolve_device(device)
    model = _new_model(model, None, device)
    spec = letterbox_spec(frames.shape[1:3], input_hw)
    clip = (torch.from_numpy(np.ascontiguousarray(frames)).to(device),
            torch.as_tensor(boxes, dtype=torch.float32).to(device),
            torch.as_tensor(cls, dtype=torch.int32).to(device),
            torch.as_tensor(valid, dtype=torch.bool).to(device))
    n_disp, total = _dispatches(cfg.steps, cfg.scan, log)
    tx = make_optimizer(model, cfg.lr, cfg.warmup, total, cfg.weight_decay)
    step_fn = make_clip_train_step(model, spec, input_hw, cfg, tx,
                                   synthetic_world=synthetic_world,
                                   synthetic_frac=synthetic_frac)
    key = prng.PRNGKey(cfg.seed)
    for i in range(n_disp):
        key, sub = prng.split(key)
        ls, ax = _read(*step_fn(sub, *clip))
        if i % max(1, n_disp // 15) == 0 or i == n_disp - 1:
            log(f"clip step {(i + 1) * cfg.scan:>5}/{total}"
                f"  loss {ls[-1]:.3f} (mean {ls.mean():.3f})"
                f"  cls {ax['cls'][-1]:.3f} iou {ax['iou'][-1]:.3f}"
                f" dfl {ax['dfl'][-1]:.3f}")
    return model


def train_reid(world: WorldSpec = WorldSpec(),
               cfg: ReIDTrainConfig = ReIDTrainConfig(), model=None,
               log=print, device=None):
    """Train the ReID embedder on synthetic identities, from ``model``'s
    weights or a seeded init; returns the f32 model on ``device`` (default
    the GPU; raises without one)."""
    from . import config as pkg_config
    from .models.reid import ReIDNet
    device = resolve_device(device)
    model = _new_model(
        model, lambda: ReIDNet(feature_dim=pkg_config.REID_FEATURE_DIM),
        device)
    n_disp, total = _dispatches(cfg.steps, cfg.scan, log, "reid steps")
    tx = make_optimizer(model, cfg.lr, cfg.warmup, total, cfg.weight_decay)
    step_fn = make_reid_train_step(model, world, cfg, tx)
    key = prng.PRNGKey(cfg.seed)
    for i in range(n_disp):
        key, sub = prng.split(key)
        ls, _ = _read(step_fn(sub), {})
        if i % max(1, n_disp // 15) == 0 or i == n_disp - 1:
            log(f"reid step {(i + 1) * cfg.scan:>5}"
                f"/{total}  loss {ls[-1]:.4f} (mean {ls.mean():.4f})")
    return model


def train_detector(variant: str = "n", world: WorldSpec = WorldSpec(),
                   input_hw: Tuple[int, int] = (640, 640),
                   cfg: TrainConfig = TrainConfig(), model=None, log=print,
                   device=None):
    """Train YOLOv8-``variant`` on the synthetic world, from ``model``'s
    weights or a seeded init; returns the f32 model on ``device`` (default
    the GPU; raises without one)."""
    from .models.yolov8 import YOLOv8
    device = resolve_device(device)
    model = _new_model(model, lambda: YOLOv8(variant=variant,
                                             num_classes=80), device)
    spec = letterbox_spec(world.hw, input_hw)
    n_disp, total = _dispatches(cfg.steps, cfg.scan, log)
    tx = make_optimizer(model, cfg.lr, cfg.warmup, total, cfg.weight_decay)
    step_fn = make_train_step(model, world, spec, input_hw, cfg, tx)
    key = prng.PRNGKey(cfg.seed)
    for i in range(n_disp):
        key, sub = prng.split(key)
        ls, ax = _read(*step_fn(sub))
        if i % max(1, n_disp // 20) == 0 or i == n_disp - 1:
            log(f"step {(i + 1) * cfg.scan:>5}/{total}"
                f"  loss {ls[-1]:.3f} (mean {ls.mean():.3f})"
                f"  cls {ax['cls'][-1]:.3f} iou {ax['iou'][-1]:.3f}"
                f" dfl {ax['dfl'][-1]:.3f}")
    return model


# --- RT-DETR: set prediction -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DetrTrainConfig:
    """RT-DETR's training on the synthetic world. The losses are
    Ultralytics' ``RTDETRDetectionLoss`` without denoising groups: Hungarian
    matching on focal class cost + L1 + GIoU (gains 2, 5, 2), varifocal
    class loss + L1 + GIoU (gains 1, 5, 2), on every decoder layer and on
    the encoder's top-k. Scenes come from a pool a world size (``pool``
    scenes each; ``refresh`` of them rendered anew over the oldest before
    every dispatch), drawn at random and flipped left-right at random; a
    step's batch is of one size."""
    batch: int = 16
    steps: int = 6000
    scan: int = 25
    lr: float = 2e-4
    warmup: int = 500
    weight_decay: float = 1e-4
    max_norm: float = 0.1           # RT-DETR's gradient clip
    pool: int = 2048
    refresh: int = 16
    seed: int = 0
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    w_class: float = 1.0
    w_bbox: float = 5.0
    w_giou: float = 2.0
    #: the varifocal loss's weight of an unmatched query's score
    #: (Ultralytics' 0.75); a larger one pushes duplicates' scores down
    vfl_alpha: float = 0.75


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    c, wh = b[..., :2], b[..., 2:]
    return torch.cat([c - wh / 2, c + wh / 2], -1)


def box_ious(a: torch.Tensor, b: torch.Tensor):
    """IoU and GIoU of xyxy boxes ``a`` and ``b`` (broadcast)."""
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    iou = inter / (union + 1e-7)
    cw = torch.maximum(a[..., 2], b[..., 2]) - torch.minimum(a[..., 0],
                                                             b[..., 0])
    ch = torch.maximum(a[..., 3], b[..., 3]) - torch.minimum(a[..., 1],
                                                             b[..., 1])
    hull = cw * ch + 1e-7
    return iou, iou - (hull - union) / hull


def match_cost(prob: torch.Tensor, boxes: torch.Tensor, gt_cls: torch.Tensor,
               gt_boxes: torch.Tensor, cfg: DetrTrainConfig,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Ultralytics' ``HungarianMatcher`` cost ``(..., Q, G)``: ``prob``
    ``(..., Q, C)`` sigmoid scores, ``boxes`` ``(..., Q, 4)`` and
    ``gt_boxes`` ``(..., G, 4)`` cxcywh, ``gt_cls`` ``(..., G)`` class
    indices."""
    idx = gt_cls.long()[..., None, :].expand(*prob.shape[:-1], -1)
    p = torch.gather(prob, -1, idx)
    neg = (1 - alpha) * p ** gamma * -(1 - p + 1e-8).log()
    pos = alpha * (1 - p) ** gamma * -(p + 1e-8).log()
    l1 = (boxes[..., :, None, :] - gt_boxes[..., None, :, :]).abs().sum(-1)
    _, giou = box_ious(cxcywh_to_xyxy(boxes)[..., :, None, :],
                       cxcywh_to_xyxy(gt_boxes)[..., None, :, :])
    return (cfg.cost_class * (pos - neg) + cfg.cost_bbox * l1
            + cfg.cost_giou * (1 - giou))


def hungarian(cost: np.ndarray):
    """Minimum-cost assignment of a ``(Q, G)`` cost, ``G <= Q``: ``(rows,
    cols)`` int64, every column assigned, ``cols`` ascending."""
    from scipy.optimize import linear_sum_assignment
    r, c = linear_sum_assignment(cost)
    order = np.argsort(c)
    return r[order].astype(np.int64), c[order].astype(np.int64)


def detr_loss(outputs, gt_boxes, gt_cls, gt_valid, cfg: DetrTrainConfig):
    """The set-prediction loss and its parts. ``outputs``: per head (each
    decoder layer, then the encoder's top-k) ``(boxes (B, Q, 4) cxcywh in
    [0, 1], logits (B, Q, C))``; the ground truth ``(B, G, 4)`` cxcywh in
    [0, 1], ``(B, G)`` class indices, ``(B, G)`` bool. Each head is matched
    on its own (one host read a call for all of them); sums are over the
    batch's boxes, divided by their count."""
    dev = gt_boxes.device
    b, q = outputs[0][1].shape[:2]
    with torch.no_grad():
        costs = torch.stack([match_cost(lg.float().sigmoid(), bx.float(),
                                        gt_cls, gt_boxes, cfg)
                             for bx, lg in outputs])
    costs = costs.double().cpu().numpy()
    valid = gt_valid.cpu().numpy()
    n_gt = max(int(valid.sum()), 1)
    parts = {"class": 0.0, "bbox": 0.0, "giou": 0.0}
    for h, (bx, lg) in enumerate(outputs):
        bi, qi, gi = [], [], []
        for f in range(b):
            cols = np.flatnonzero(valid[f])
            if not len(cols):
                continue
            r, c = hungarian(costs[h, f][:, cols])
            bi.append(np.full(len(r), f))
            qi.append(r)
            gi.append(cols[c])
        cat = (lambda xs: torch.as_tensor(np.concatenate(xs)
                                          if xs else np.zeros(0, np.int64),
                                          device=dev))
        bi, qi, gi = cat(bi), cat(qi), cat(gi)
        pb, tb = bx[bi, qi].float(), gt_boxes[bi, gi]
        iou, giou = box_ious(cxcywh_to_xyxy(pb), cxcywh_to_xyxy(tb))
        logits = lg.float()
        label = torch.zeros_like(logits)
        label[bi, qi, gt_cls[bi, gi].long()] = 1.0
        score = torch.zeros_like(logits)
        score[bi, qi, gt_cls[bi, gi].long()] = iou.detach()
        # Ultralytics' VarifocalLoss (gamma 2)
        weight = cfg.vfl_alpha * logits.sigmoid().detach() ** 2 \
            * (1 - label) + score * label
        vfl = (F.binary_cross_entropy_with_logits(logits, score,
                                                  reduction="none")
               * weight).sum()
        parts["class"] = parts["class"] + vfl / n_gt
        parts["bbox"] = parts["bbox"] + (pb - tb).abs().sum() / n_gt
        parts["giou"] = parts["giou"] + (1 - giou).sum() / n_gt
    loss = (cfg.w_class * parts["class"] + cfg.w_bbox * parts["bbox"]
            + cfg.w_giou * parts["giou"])
    return loss, parts


def detr_outputs(model, x: torch.Tensor):
    """RT-DETR's training forward: per head (the six decoder layers, then
    the encoder's top-k) ``(boxes, logits)``, the decoder started from the
    detached selection as Ultralytics trains it."""
    dec = model.decoder
    feats, shapes = model.encode(model.backbone(x))
    top, ref, enc_boxes, enc_logits, _, _ = dec.select(feats, shapes)
    boxes, logits = dec.layers_forward(top.detach(), ref.detach(), feats,
                                       shapes, all_layers=True)
    return list(zip(boxes, logits)) + [(enc_boxes, enc_logits)]


class ScenePool:
    """Scenes rendered on the device for RT-DETR's training: frames
    ``(P, H, W, 3)`` u8 and their ground truth, one pool a world;
    :meth:`refresh` renders fresh scenes over the oldest."""

    def __init__(self, world: WorldSpec, n: int, seed: int, device,
                 chunk: int = 64):
        frames, boxes, cls, valid = [], [], [], []
        keys = prng.split(prng.PRNGKey(seed), n)
        for lo in range(0, n, chunk):
            fr, bx, cl, va = _render_batch(keys[lo:lo + chunk], world, device)
            for lst, t in zip((frames, boxes, cls, valid), (fr, bx, cl, va)):
                lst.append(t)
        self.frames, self.boxes, self.cls, self.valid = (
            torch.cat(t) for t in (frames, boxes, cls, valid))
        self.world = world
        self.key = prng.PRNGKey(seed + 1)
        self.oldest = 0

    def refresh(self, n: int):
        """Render ``n`` new scenes over the ``n`` oldest."""
        if n <= 0:
            return
        self.key, sub = prng.split(self.key)
        new = _render_batch(prng.split(sub, n), self.world,
                            self.frames.device)
        rows = (self.oldest + torch.arange(n)) % len(self.frames)
        rows = rows.to(self.frames.device)
        for dst, t in zip((self.frames, self.boxes, self.cls, self.valid),
                          new):
            dst[rows] = t
        self.oldest = (self.oldest + n) % len(self.frames)

    def batch(self, rng: np.random.Generator, b: int):
        """``b`` scenes drawn at random, each flipped left-right with
        probability one half: frames and gt (xyxy source pixels)."""
        dev = self.frames.device
        idx = torch.as_tensor(rng.integers(len(self.frames), size=b),
                              device=dev)
        flip = torch.as_tensor(rng.random(b) < 0.5, device=dev)
        frames = self.frames[idx]
        frames = torch.where(flip[:, None, None, None], frames.flip(2),
                             frames)
        boxes = self.boxes[idx]
        w = float(self.world.hw[1])
        mirrored = torch.stack([w - boxes[..., 2], boxes[..., 1],
                                w - boxes[..., 0], boxes[..., 3]], -1)
        boxes = torch.where(flip[:, None, None], mirrored, boxes)
        return frames, boxes, self.cls[idx], self.valid[idx]


def detr_targets(boxes, cls, valid, spec: LetterboxSpec,
                 input_hw: Tuple[int, int]):
    """Source-pixel xyxy ground truth -> cxcywh normalized to the
    letterboxed input, and which boxes are trainable (valid and wider and
    taller than one input pixel)."""
    r, left, top = _f32(spec.ratio), float(spec.left), float(spec.top)
    ih, iw = input_hw
    x1 = (boxes[..., 0] * r + left) / iw
    y1 = (boxes[..., 1] * r + top) / ih
    x2 = (boxes[..., 2] * r + left) / iw
    y2 = (boxes[..., 3] * r + top) / ih
    out = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
    ok = valid & ((x2 - x1) * iw > 1) & ((y2 - y1) * ih > 1)
    return out, ok


def make_detr_train_step(model, pools, input_hw: Tuple[int, int],
                         cfg: DetrTrainConfig, tx: AdamW,
                         stage_timer=None):
    """RT-DETR's dispatch: ``multi_step(rng) -> (losses (scan,), parts)``,
    ``cfg.scan`` optimizer steps on batches drawn from ``pools`` in turn,
    in bf16 autocast on the card (f32 on the CPU), the model f32 and
    channels-last, in train mode (BatchNorm on batch statistics)."""
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    specs = [letterbox_spec(p.world.hw, input_hw) for p in pools]
    dtype = torch.bfloat16 if cuda else torch.float32
    count = [0]

    def one_step(rng):
        p = count[0] % len(pools)
        count[0] += 1
        frames, boxes, cls, valid = pools[p].batch(rng, cfg.batch)
        _mark(stage_timer, "render")
        x = letterbox(frames, specs[p], dtype).contiguous(
            memory_format=torch.channels_last)
        _mark(stage_timer, "letterbox")
        tb, ok = detr_targets(boxes, cls, valid, specs[p], input_hw)
        ctx = torch.autocast("cuda", torch.bfloat16) if cuda \
            else _without_onednn()
        with ctx:
            outs = detr_outputs(model, x)
        loss, parts = detr_loss(outs, tb, cls, ok, cfg)
        _mark(stage_timer, "forward")
        _optimizer_step(loss, tx, stage_timer)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    def multi_step(rng):
        for p in pools:
            p.refresh(cfg.refresh)
        if stage_timer is not None:
            stage_timer.start()
        losses, auxes = zip(*[one_step(rng) for _ in range(cfg.scan)])
        return torch.stack(losses), _stack_aux(auxes)

    return multi_step


def train_rtdetr(worlds=(WorldSpec(), WorldSpec(hw=(720, 1280))),
                 input_hw: Tuple[int, int] = (640, 640),
                 cfg: DetrTrainConfig = DetrTrainConfig(), model=None,
                 log=print, device=None, max_seconds: float | None = None):
    """Train RT-DETR-L on the synthetic world, a pool of scenes a world
    size in ``worlds``, from ``model``'s weights or Ultralytics'
    initialisation; returns the f32 model (trained form) on ``device``.
    ``max_seconds``: stop after the dispatch that would pass that many
    seconds of stepping (the schedule then ends early)."""
    import time
    from .models.rtdetr import RTDETR, init_weights_
    device = resolve_device(device)
    if model is None:
        model = init_weights_(RTDETR(), seed=cfg.seed)
    model = model.to(device=device, dtype=torch.float32,
                     memory_format=torch.channels_last).train()
    t0 = time.perf_counter()
    pools = [ScenePool(w, cfg.pool, cfg.seed + 1000 * i, device)
             for i, w in enumerate(worlds)]
    log(f"rendered {len(pools)} pools of {cfg.pool} scenes in "
        f"{time.perf_counter() - t0:.0f}s")
    n_disp, total = _dispatches(cfg.steps, cfg.scan, log)
    sched = warmup_cosine_schedule(cfg.lr, cfg.warmup,
                                   max(total, cfg.warmup + 1), cfg.lr / 20)
    tx = AdamW(model.parameters(), sched, cfg.weight_decay, cfg.max_norm)
    step_fn = make_detr_train_step(model, pools, input_hw, cfg, tx)
    rng = np.random.default_rng(cfg.seed)
    t0 = time.perf_counter()
    for i in range(n_disp):
        ls, ax = _read(*step_fn(rng))
        spent = time.perf_counter() - t0
        last = i == n_disp - 1 or (max_seconds is not None
                                   and spent * (i + 2) / (i + 1)
                                   > max_seconds)
        if i % max(1, n_disp // 40) == 0 or last:
            log(f"step {(i + 1) * cfg.scan:>5}/{total}"
                f"  loss {ls[-1]:.3f} (mean {ls.mean():.3f})"
                f"  class {ax['class'][-1]:.3f} bbox {ax['bbox'][-1]:.3f}"
                f" giou {ax['giou'][-1]:.3f}"
                f"  {1e3 * spent / ((i + 1) * cfg.scan):.1f} ms a step")
        if last:
            break
    return model
