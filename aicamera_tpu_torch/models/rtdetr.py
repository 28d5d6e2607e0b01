"""RT-DETR-L (Lv et al., "DETRs Beat YOLOs on Real-time Object Detection",
arXiv:2304.08069) in PyTorch, at the published widths of Ultralytics'
``rtdetr-l.yaml``.

- Backbone HGNetv2-L: ``HGStem(3, 32, 48)``; ``HGBlock(48, 48, 128, k3,
  n6)``; ``DWConv(128, s2)``; ``HGBlock(128, 96, 512, k3, n6)``;
  ``DWConv(512, s2)``; three ``HGBlock(., 192, 1024, k5, n6, LightConv)``
  (the first without a shortcut); ``DWConv(1024, s2)``; ``HGBlock(1024,
  384, 2048, k5, n6, LightConv)``. ReLU throughout; the DWConvs have none.
- Encoder: 1x1 input projections to 256 (BN, no activation) of the stride
  8/16/32 maps; ``AIFI`` (one post-norm transformer layer, 8 heads, FFN
  1024, GELU, Ultralytics' 2-D sin-cos embedding) over the stride-32 map;
  CCFM: lateral 1x1 convs, nearest 2x upsampling, ``RepC3(512, 256, n3)``
  top-down and bottom-up with 3x3 stride-2 downsampling. The head's convs
  use SiLU.
- Decoder (``RTDETRDecoder``, eval form, no denoising queries): 1x1 + BN
  input projections, query selection of the top 300 of the 8,400 anchors by
  their best class logit (anchors: grid centres, wh ``0.05 * 2**level``,
  masked to (0.01, 0.99), in logit space), six layers of self-attention,
  multi-scale deformable cross-attention (8 heads, 3 levels, 4 points;
  sampled with ``F.grid_sample`` as Ultralytics'
  ``multi_scale_deformable_attn_pytorch``) and a ReLU FFN, each refining
  the boxes; the last layer's class logits and boxes are the output.

A ``Conv`` is conv + BatchNorm + activation, as trained and as the
checkpoint stores it; :meth:`RTDETR.fuse` folds every BN into its conv's
bias and every ``RepConv``'s 1x1 branch into its 3x3 (the inference form).
In bf16 the convolutions run channels-last (``layers.layout``).

Precision inside a bf16 forward: the anchors, the reference boxes, their
refinement (``inverse_sigmoid`` + the head's delta, then ``sigmoid``), the
sampling locations and the bilinear sampling itself are f32; the sampled
values return to bf16 before the attention weights are applied.

Module names are the checkpoint's Flax-layout paths
(``runtime/params.py::rtdetr_state_dict_from_flax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import layers

NUM_QUERIES = 300
HIDDEN = 256
HEADS = 8
LEVELS = 3
POINTS = 4
DEC_LAYERS = 6
FFN = 1024
STRIDES = (8, 16, 32)
BN_EPS = 1e-3   # Ultralytics' ``initialize_weights``


def _act(name):
    return {"relu": F.relu, "silu": F.silu, None: None}[name]


class Conv(nn.Module):
    """Conv (no bias) + BN + activation; after :meth:`fuse` a biased conv
    + activation."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p: int | None = None, g: int = 1, act: str | None = "relu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p,
                              groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=0.03)
        self.act = act

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        f = _act(self.act)
        return y if f is None else f(y)

    def folded(self):
        """``(weight, bias)`` of the conv with its BN folded in (f32)."""
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        w = self.conv.weight * scale.reshape(-1, 1, 1, 1)
        return w, bn.bias - bn.running_mean * scale

    @torch.no_grad()
    def fuse(self):
        if self.bn is None:
            return
        w, b = self.folded()
        c = self.conv
        conv = nn.Conv2d(c.in_channels, c.out_channels, c.kernel_size,
                         c.stride, c.padding, groups=c.groups, bias=True)
        conv.weight.copy_(w)
        conv.bias.copy_(b)
        self.conv, self.bn = conv.to(w.device), None


class LightConv(nn.Module):
    """1x1 conv without activation, then a depthwise kxk conv with ReLU."""

    def __init__(self, c1: int, c2: int, k: int):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=None)
        self.conv2 = Conv(c2, c2, k, g=c2)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HGStem(nn.Module):
    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2)
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0)
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0)
        self.stem3 = Conv(cm * 2, cm, 3, 2)
        self.stem4 = Conv(cm, c2, 1)

    def forward(self, x):
        x = F.pad(self.stem1(x), [0, 1, 0, 1])
        x2 = self.stem2b(F.pad(self.stem2a(x), [0, 1, 0, 1]))
        x1 = F.max_pool2d(x, 2, 1, 0, ceil_mode=True)
        return self.stem4(self.stem3(layers.cat_channels([x1, x2])))


class HGBlock(nn.Module):
    """n convs (or LightConvs) in a chain; the input and every output
    concatenated, squeezed by a 1x1 conv to c2/2 and excited to c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int, n: int = 6,
                 light: bool = False, shortcut: bool = False):
        super().__init__()
        for i in range(n):
            cin = c1 if i == 0 else cm
            self.add_module(f"m{i}", LightConv(cin, cm, k) if light
                            else Conv(cin, cm, k))
        self.n = n
        self.sc = Conv(c1 + n * cm, c2 // 2, 1)
        self.ec = Conv(c2 // 2, c2, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        y = self.ec(self.sc(layers.cat_channels(ys)))
        return y + x if self.add else y


class Backbone(nn.Module):
    """HGNetv2-L: the stride 8, 16 and 32 maps (512, 1024, 2048
    channels)."""

    def __init__(self):
        super().__init__()
        self.stem = HGStem(3, 32, 48)
        self.stage1 = HGBlock(48, 48, 128, 3)
        self.down1 = Conv(128, 128, 3, 2, g=128, act=None)
        self.stage2 = HGBlock(128, 96, 512, 3)
        self.down2 = Conv(512, 512, 3, 2, g=512, act=None)
        self.stage3a = HGBlock(512, 192, 1024, 5, light=True)
        self.stage3b = HGBlock(1024, 192, 1024, 5, light=True, shortcut=True)
        self.stage3c = HGBlock(1024, 192, 1024, 5, light=True, shortcut=True)
        self.down3 = Conv(1024, 1024, 3, 2, g=1024, act=None)
        self.stage4 = HGBlock(1024, 384, 2048, 5, light=True)

    def forward(self, x):
        p3 = self.stage2(self.down1(self.stage1(self.stem(x))))
        p4 = self.stage3c(self.stage3b(self.stage3a(self.down2(p3))))
        p5 = self.stage4(self.down3(p4))
        return p3, p4, p5


class RepConv(nn.Module):
    """SiLU(3x3 conv + BN + 1x1 conv + BN); :meth:`fuse` makes it one
    biased 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, c, 3, act=None)
        self.conv2 = Conv(c, c, 1, act=None)
        self.fused = None

    def forward(self, x):
        if self.fused is not None:
            return F.silu(self.fused(x))
        return F.silu(self.conv1(x) + self.conv2(x))

    @torch.no_grad()
    def fuse(self):
        if self.fused is not None:
            return
        w3, b3 = self.conv1.folded()
        w1, b1 = self.conv2.folded()
        conv = nn.Conv2d(w3.shape[1], w3.shape[0], 3, 1, 1, bias=True)
        conv.weight.copy_(w3 + F.pad(w1, [1, 1, 1, 1]))
        conv.bias.copy_(b3 + b1)
        self.fused = conv.to(w3.device)
        del self.conv1, self.conv2


class RepC3(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 3):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, act="silu")
        self.cv2 = Conv(c1, c2, 1, act="silu")
        for i in range(n):
            self.add_module(f"m{i}", RepConv(c2))
        self.n = n

    def forward(self, x):
        y = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m{i}")(y)
        return y + self.cv2(x)


def sincos_embedding(h: int, w: int, dim: int = HIDDEN,
                     temperature: float = 10000.0, device=None):
    """Ultralytics' ``AIFI.build_2d_sincos_position_embedding(w, h)``,
    ``(h * w, dim)`` f32, with its grid order (``meshgrid(w, h, "ij")``)."""
    gw = torch.arange(w, dtype=torch.float32, device=device)
    gh = torch.arange(h, dtype=torch.float32, device=device)
    gw, gh = torch.meshgrid(gw, gh, indexing="ij")
    pos = dim // 4
    omega = 1.0 / temperature ** (torch.arange(
        pos, dtype=torch.float32, device=device) / pos)
    ow = gw.flatten()[:, None] * omega[None]
    oh = gh.flatten()[:, None] * omega[None]
    return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)


class Attention(nn.Module):
    """Multi-head attention with separate q, k, v projections (the math of
    ``nn.MultiheadAttention``)."""

    def __init__(self, d: int = HIDDEN, heads: int = HEADS):
        super().__init__()
        self.q, self.k, self.v = (nn.Linear(d, d) for _ in range(3))
        self.out = nn.Linear(d, d)
        self.heads = heads

    def forward(self, q, k, v):
        b, lq, d = q.shape
        h = self.heads

        def split(t):
            return t.reshape(b, -1, h, d // h).transpose(1, 2)

        o = F.scaled_dot_product_attention(split(self.q(q)), split(self.k(k)),
                                           split(self.v(v)))
        return self.out(o.transpose(1, 2).reshape(b, lq, d))


class AIFI(nn.Module):
    """One post-norm transformer encoder layer over the stride-32 map."""

    def __init__(self, d: int = HIDDEN, ffn: int = FFN, heads: int = HEADS):
        super().__init__()
        self.attn = Attention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x):
        b, c, h, w = x.shape
        src = x.flatten(2).transpose(1, 2)
        pos = sincos_embedding(h, w, c, device=x.device).to(x.dtype)
        qk = src + pos
        src = self.norm1(src + self.attn(qk, qk, src))
        src = self.norm2(src + self.fc2(F.gelu(self.fc1(src))))
        return src.transpose(1, 2).reshape(b, c, h, w).contiguous(
            memory_format=layers.layout(x.dtype))


class Encoder(nn.Module):
    """Input projections, AIFI and CCFM: three 256-channel maps."""

    def __init__(self, chs=(512, 1024, 2048), d: int = HIDDEN):
        super().__init__()
        for i, c in enumerate(chs):
            self.add_module(f"proj{i}", Conv(c, d, 1, act=None))
        self.aifi = AIFI(d)
        self.lat0 = Conv(d, d, 1, act="silu")
        self.fpn0 = RepC3(2 * d, d)
        self.lat1 = Conv(d, d, 1, act="silu")
        self.fpn1 = RepC3(2 * d, d)
        self.down0 = Conv(d, d, 3, 2, act="silu")
        self.pan0 = RepC3(2 * d, d)
        self.down1 = Conv(d, d, 3, 2, act="silu")
        self.pan1 = RepC3(2 * d, d)

    def forward(self, p3, p4, p5):
        cat = layers.cat_channels
        y5 = self.lat0(self.aifi(self.proj2(p5)))
        y4 = self.lat1(self.fpn0(cat([layers.upsample2x(y5),
                                       self.proj1(p4)])))
        x3 = self.fpn1(cat([layers.upsample2x(y4), self.proj0(p3)]))
        f4 = self.pan0(cat([self.down0(x3), y4]))
        f5 = self.pan1(cat([self.down1(f4), y5]))
        return x3, f4, f5


class MLP(nn.Module):
    def __init__(self, din: int, dh: int, dout: int, n: int):
        super().__init__()
        dims = [din] + [dh] * (n - 1) + [dout]
        for i in range(n):
            self.add_module(f"l{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n = n

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"l{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def msda_sample(value: torch.Tensor, shapes, loc: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable sampling: ``value`` ``(B, S, H, D)`` over the
    levels' ``shapes`` [(h, w), ...], ``loc`` ``(B, Q, H, L, P, 2)`` in
    [0, 1] (x, y), ``weights`` ``(B, Q, H, L, P)`` -> ``(B, Q, H * D)``.
    Bilinear, zeros outside, half-pixel centres (``grid_sample`` with
    ``align_corners=False``); the sampling runs in the locations' dtype and
    the weighted sum in ``value``'s."""
    b, _, nh, dh = value.shape
    _, q, _, nl, npt, _ = loc.shape
    grids = 2 * loc - 1
    out = []
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            b * nh, dh, h, w).to(loc.dtype)
        start += h * w
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (BH, Q, P, 2)
        out.append(F.grid_sample(v, g, mode="bilinear",
                                 padding_mode="zeros", align_corners=False))
    sampled = torch.stack(out, -2).flatten(-2).to(value.dtype)  # (BH,D,Q,LP)
    w = weights.transpose(1, 2).reshape(b * nh, 1, q, nl * npt)
    o = (sampled * w).sum(-1).reshape(b, nh * dh, q)
    return o.transpose(1, 2)


class MSDeformAttn(nn.Module):
    def __init__(self, d: int = HIDDEN, levels: int = LEVELS,
                 heads: int = HEADS, points: int = POINTS):
        super().__init__()
        self.offsets = nn.Linear(d, heads * levels * points * 2)
        self.weights = nn.Linear(d, heads * levels * points)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.levels, self.heads, self.points = levels, heads, points

    def forward(self, query, ref, feats, shapes):
        """``ref`` ``(B, Q, 4)`` cxcywh in [0, 1], f32."""
        b, q, d = query.shape
        nh, nl, npt = self.heads, self.levels, self.points
        value = self.value(feats).reshape(b, feats.shape[1], nh, d // nh)
        off = self.offsets(query).reshape(b, q, nh, nl, npt, 2).float()
        aw = F.softmax(self.weights(query).reshape(b, q, nh, nl * npt), -1)
        aw = aw.reshape(b, q, nh, nl, npt)
        r = ref[:, :, None, None, None]
        loc = r[..., :2] + off / npt * r[..., 2:] * 0.5
        return self.out(msda_sample(value, shapes, loc, aw.to(value.dtype)))


class DecoderLayer(nn.Module):
    def __init__(self, d: int = HIDDEN, ffn: int = FFN):
        super().__init__()
        self.attn = Attention(d)
        self.norm1 = nn.LayerNorm(d)
        self.msda = MSDeformAttn(d)
        self.norm2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, x, ref, feats, shapes, pos):
        qk = x + pos
        x = self.norm1(x + self.attn(qk, qk, x))
        x = self.norm2(x + self.msda(x + pos, ref, feats, shapes))
        return self.norm3(x + self.fc2(F.relu(self.fc1(x))))


def make_anchors(shapes, device, grid: float = 0.05, eps: float = 1e-2):
    """Anchors in logit space ``(S, 4)`` f32 (inf where masked) and the
    valid mask ``(S, 1)``."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = torch.full_like(xy, grid * 2.0 ** lvl)
        out.append(torch.cat([xy, wh], -1).reshape(h * w, 4))
    a = torch.cat(out)
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdim=True)
    a = torch.log(a / (1 - a)).masked_fill(~valid, float("inf"))
    return a, valid


class Decoder(nn.Module):
    def __init__(self, num_classes: int = 80, d: int = HIDDEN,
                 num_queries: int = NUM_QUERIES, layers_: int = DEC_LAYERS):
        super().__init__()
        for i in range(LEVELS):
            self.add_module(f"proj{i}", Conv(d, d, 1, act=None))
        self.enc_linear = nn.Linear(d, d)
        self.enc_norm = nn.LayerNorm(d)
        self.enc_score = nn.Linear(d, num_classes)
        self.enc_bbox = MLP(d, d, 4, 3)
        self.query_pos = MLP(4, 2 * d, d, 2)
        for i in range(layers_):
            self.add_module(f"layer{i}", DecoderLayer(d))
            self.add_module(f"score{i}", nn.Linear(d, num_classes))
            self.add_module(f"bbox{i}", MLP(d, d, 4, 3))
        self.num_queries = num_queries
        self.n_layers = layers_
        self._anchors = {}

    def anchors(self, shapes, device):
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = make_anchors(shapes, device)
        return self._anchors[key]

    def memory(self, maps):
        """The three maps projected and flattened: ``(B, S, d)`` and the
        levels' shapes."""
        feats, shapes = [], []
        for i, m in enumerate(maps):
            m = getattr(self, f"proj{i}")(m)
            shapes.append(tuple(m.shape[2:]))
            feats.append(m.flatten(2).transpose(1, 2))
        return torch.cat(feats, 1), shapes

    def select(self, feats, shapes, index=None):
        """Query selection: ``(embed, ref_logit (f32), enc_boxes,
        enc_logits, index)`` of the top ``num_queries`` anchors by their
        best class logit (``index`` given: those anchors, teacher-forced),
        and the encoder's class logits over every anchor."""
        anchors, valid = self.anchors(shapes, feats.device)
        mem = self.enc_norm(self.enc_linear(feats * valid.to(feats.dtype)))
        logits = self.enc_score(mem)
        if index is None:
            index = torch.topk(logits.max(-1).values, self.num_queries,
                               dim=1).indices
        top = torch.gather(mem, 1, index[..., None].expand(-1, -1,
                                                            mem.shape[-1]))
        ref = self.enc_bbox(top).float() + anchors[index]
        enc_logits = torch.gather(logits, 1, index[..., None].expand(
            -1, -1, logits.shape[-1]))
        return top, ref, ref.sigmoid(), enc_logits, index, logits

    def layers_forward(self, embed, ref_logit, feats, shapes, all_layers=False):
        """The decoder layers from the selected queries: the last layer's
        ``(boxes cxcywh f32, logits)``; ``all_layers``: every layer's, with
        Ultralytics' training form (each box refined from the layer
        before's, the reference detached between layers)."""
        x = embed
        ref = ref_logit.sigmoid()
        boxes, logits = [], []
        last = None
        for i in range(self.n_layers):
            layer = getattr(self, f"layer{i}")
            x = layer(x, ref, feats, shapes,
                      self.query_pos(ref.to(x.dtype)))
            delta = getattr(self, f"bbox{i}")(x).float()
            refined = torch.sigmoid(delta + inverse_sigmoid(ref))
            if all_layers:
                logits.append(getattr(self, f"score{i}")(x))
                boxes.append(refined if last is None else
                             torch.sigmoid(delta + inverse_sigmoid(last)))
                last = refined
                ref = refined.detach()
            else:
                ref = refined
        if all_layers:
            return boxes, logits
        return ref, getattr(self, f"score{self.n_layers - 1}")(x)


class RTDETR(nn.Module):
    """RT-DETR-L. Input NCHW float in [0, 1] ``(B, 3, H, W)``, the letterbox
    kernel's output; :meth:`forward` returns the last decoder layer's boxes
    ``(B, Q, 4)`` (cxcywh, normalized to the input, f32) and class logits
    ``(B, Q, C)``. The stages are methods (:meth:`features`,
    :meth:`encode`, :meth:`decode`) so that a caller can stamp between
    them."""

    def __init__(self, num_classes: int = 80,
                 num_queries: int = NUM_QUERIES):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = Backbone()
        self.encoder = Encoder()
        self.decoder = Decoder(num_classes, num_queries=num_queries)
        self.fused = False

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.enc_linear.weight.dtype

    def features(self, x):
        return self.backbone(layers.to_layout(x, self.dtype))

    def encode(self, maps):
        feats, shapes = self.decoder.memory(self.encoder(*maps))
        return feats, shapes

    def decode(self, feats, shapes, index=None):
        embed, ref, _, _, _, _ = self.decoder.select(feats, shapes, index)
        return self.decoder.layers_forward(embed, ref, feats, shapes)

    def forward(self, x):
        return self.decode(*self.encode(self.features(x)))

    @torch.no_grad()
    def fuse(self):
        """The inference form: BNs folded, RepConvs merged (in place)."""
        for m in list(self.modules()):
            if isinstance(m, (Conv, RepConv)):
                m.fuse()
        self.fused = True
        return self

    def to_inference(self, device, dtype):
        """Fused, on ``device`` in ``dtype`` and its layout, eval mode."""
        self.fuse()
        return self.to(device=device, dtype=dtype,
                       memory_format=layers.layout(dtype)).eval()


def init_weights_(model: RTDETR, seed: int = 0,
                  prior: float = 0.01) -> RTDETR:
    """Ultralytics' initialisation, drawn from ``seed``: convs He-normal,
    BN weight 1, bias 0; Linear xavier-uniform with zero biases; class
    biases at the ``prior``; the box heads' last layers and the deformable
    attention's offset and weight projections zero, the offsets' bias on
    Deformable DETR's grid."""
    gen = torch.Generator().manual_seed(int(seed))
    bias_cls = -math.log((1 - prior) / prior)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * math.sqrt(2.0 / fan_in))
            elif isinstance(m, nn.Linear):
                a = math.sqrt(6.0 / (m.in_features + m.out_features))
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen)
                                * 2 - 1) * a)
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        dec = model.decoder
        heads = [dec.enc_score] + [getattr(dec, f"score{i}")
                                   for i in range(dec.n_layers)]
        for h in heads:
            h.bias.fill_(bias_cls)
        for mlp in [dec.enc_bbox] + [getattr(dec, f"bbox{i}")
                                     for i in range(dec.n_layers)]:
            last = getattr(mlp, f"l{mlp.n - 1}")
            last.weight.zero_()
            last.bias.zero_()
        for i in range(dec.n_layers):
            ms = getattr(dec, f"layer{i}").msda
            ms.offsets.weight.zero_()
            th = torch.arange(ms.heads, dtype=torch.float32) * (
                2.0 * math.pi / ms.heads)
            grid = torch.stack([th.cos(), th.sin()], -1)
            grid = grid / grid.abs().max(-1, keepdim=True).values
            grid = grid.view(ms.heads, 1, 1, 2).repeat(1, ms.levels,
                                                       ms.points, 1)
            for p in range(ms.points):
                grid[:, :, p] *= p + 1
            ms.offsets.bias.copy_(grid.flatten())
            ms.weights.weight.zero_()
            ms.weights.bias.zero_()
    return model


def postprocess(boxes: torch.Tensor, logits: torch.Tensor, input_hw,
                score_threshold: float, max_det: int = 100):
    """The NMS-free post-process, in fixed shapes: per query its best class
    score (sigmoid) and that class; the ``max_det`` best queries by score
    (a stable sort: ties keep the query order); those at or above
    ``score_threshold`` come first and are counted. Returns ``(num (B,)
    int32, boxes (B, max_det, 4) xyxy in input pixels f32, scores (B,
    max_det) f32, labels (B, max_det) int32)``, as ``ops.nms.
    fused_decode_nms`` returns them."""
    prob = logits.float().sigmoid()
    best, cls = prob.max(-1)
    order = torch.sort(best, dim=1, descending=True, stable=True).indices
    order = order[:, :max_det]
    scores = torch.gather(best, 1, order)
    labels = torch.gather(cls, 1, order).to(torch.int32)
    b = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    ih, iw = input_hw
    c, half = b[..., :2], b[..., 2:] / 2
    lo, hi = c - half, c + half
    xyxy = torch.stack([lo[..., 0] * iw, lo[..., 1] * ih,
                        hi[..., 0] * iw, hi[..., 1] * ih], -1)
    num = (scores >= score_threshold).sum(1, dtype=torch.int32)
    return num, xyxy, scores, labels
