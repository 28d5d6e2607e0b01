"""RT-DETR-L as a plain function of its Flax-layout tree.

Written from the paper (arXiv:2304.08069) and Ultralytics' modules
(``HGStem``, ``HGBlock``, ``LightConv``, ``RepC3``, ``RepConv``, ``AIFI``,
``MSDeformAttn``, ``DeformableTransformerDecoderLayer``, ``RTDETRDecoder``),
with no code of the program: every BatchNorm applied as its running
statistics say (eps 1e-3), every ``RepConv``'s 3x3 and 1x1 branches run
apart and summed, attention through explicit softmax products, the
deformable sampling with ``F.grid_sample`` as
``multi_scale_deformable_attn_pytorch`` does it. The tree's names are the
program's module paths (``conv``/``bn`` of a conv block, ``q``/``k``/``v``/
``out`` of an attention, ``l0``... of an MLP).

``precision``: ``"f32"`` (the reference; TF32 off by the caller) or
``"fp8"`` (the control: every convolution's and dense layer's weights, per
output channel, and its input, per sample, rounded to float8 e4m3 with
their scales, products summed in f32).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .nets import _fp8

BN_EPS = 1e-3


def tree_to_device(tree: dict, device) -> dict:
    """Nested numpy tree -> nested f32 tensors on ``device``, kept in the
    Flax layout (conv kernels HWIO, Dense kernels ``(in, out)``)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return {k: tree_to_device(v, device) if isinstance(v, dict) else
            torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)
            for k, v in tree.items()}


class RTDETRRef:
    """``(B, 3, H, W)`` RGB in [0, 1] -> the last decoder layer's
    ``(boxes (B, Q, 4) cxcywh in [0, 1], logits (B, Q, C))``; the stages
    are methods so that a test can hold each one apart."""

    def __init__(self, tree: dict, precision: str = "f32",
                 num_queries: int = 300):
        self.p = tree
        self.precision = precision
        self.num_queries = num_queries

    # --- layers -------------------------------------------------------------

    def conv(self, node, x, stride=1, pad=None, groups=1, act=None):
        """Conv (HWIO kernel, no bias) + BN + activation."""
        w = node["conv"]["kernel"].permute(3, 2, 0, 1)
        if self.precision == "fp8":
            w, x = _fp8(w, (1, 2, 3)), _fp8(x, (1, 2, 3))
        k = w.shape[-1]
        y = F.conv2d(x, w, None, stride, k // 2 if pad is None else pad,
                     groups=groups)
        bn = node["bn"]
        y = (y - bn["mean"][:, None, None]) \
            / torch.sqrt(bn["var"][:, None, None] + BN_EPS) \
            * bn["scale"][:, None, None] + bn["bias"][:, None, None]
        if act == "relu":
            return torch.relu(y)
        if act == "silu":
            return y * torch.sigmoid(y)
        return y

    def dense(self, node, x):
        w = node["kernel"]
        if self.precision == "fp8":
            w, x = _fp8(w, (0,)), _fp8(x, tuple(range(1, x.ndim)))
        return x @ w + node["bias"]

    @staticmethod
    def norm(node, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * node["scale"] \
            + node["bias"]

    def mlp(self, node, x):
        n = len(node)
        for i in range(n):
            x = self.dense(node[f"l{i}"], x)
            if i < n - 1:
                x = torch.relu(x)
        return x

    def attention(self, node, q, k, v, heads=8):
        b, lq, d = q.shape
        dh = d // heads
        qh = self.dense(node["q"], q).reshape(b, lq, heads, dh).transpose(1, 2)
        kh = self.dense(node["k"], k).reshape(b, -1, heads, dh).transpose(1, 2)
        vh = self.dense(node["v"], v).reshape(b, -1, heads, dh).transpose(1, 2)
        a = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dh), -1)
        o = (a @ vh).transpose(1, 2).reshape(b, lq, d)
        return self.dense(node["out"], o)

    # --- backbone -----------------------------------------------------------

    def hgblock(self, node, x, k, light, shortcut):
        ys = [x]
        i = 0
        while f"m{i}" in node:
            m = node[f"m{i}"]
            if light:
                y = self.conv(m["conv1"], ys[-1])
                c = y.shape[1]
                y = self.conv(m["conv2"], y, groups=c, act="relu")
            else:
                y = self.conv(m, ys[-1], act="relu")
            ys.append(y)
            i += 1
        y = self.conv(node["sc"], torch.cat(ys, 1), act="relu")
        y = self.conv(node["ec"], y, act="relu")
        return y + x if shortcut and y.shape == x.shape else y

    def backbone(self, x):
        b = self.p["backbone"]
        s = b["stem"]
        x = self.conv(s["stem1"], x, 2, act="relu")
        x = F.pad(x, [0, 1, 0, 1])
        x2 = self.conv(s["stem2a"], x, 1, 0, act="relu")
        x2 = self.conv(s["stem2b"], F.pad(x2, [0, 1, 0, 1]), 1, 0,
                       act="relu")
        x1 = F.max_pool2d(x, 2, 1, 0, ceil_mode=True)
        x = self.conv(s["stem3"], torch.cat([x1, x2], 1), 2, act="relu")
        x = self.conv(s["stem4"], x, act="relu")
        x = self.hgblock(b["stage1"], x, 3, False, False)
        x = self.conv(b["down1"], x, 2, groups=x.shape[1])
        p3 = self.hgblock(b["stage2"], x, 3, False, False)
        x = self.conv(b["down2"], p3, 2, groups=p3.shape[1])
        x = self.hgblock(b["stage3a"], x, 5, True, False)
        x = self.hgblock(b["stage3b"], x, 5, True, True)
        p4 = self.hgblock(b["stage3c"], x, 5, True, True)
        x = self.conv(b["down3"], p4, 2, groups=p4.shape[1])
        p5 = self.hgblock(b["stage4"], x, 5, True, False)
        return p3, p4, p5

    # --- encoder ------------------------------------------------------------

    @staticmethod
    def sincos(h, w, dim, device, temperature=10000.0):
        """Ultralytics' ``build_2d_sincos_position_embedding(w, h)``: token
        ``i`` of the row-major ``(h, w)`` map takes the ``i``-th row of the
        ``(w, h)``-ordered grid."""
        pos = dim // 4
        omega = 1.0 / temperature ** (torch.arange(pos, device=device)
                                      .float() / pos)
        i = torch.arange(h * w, device=device)
        gw, gh = (i // h).float(), (i % h).float()
        ow, oh = gw[:, None] * omega, gh[:, None] * omega
        return torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)

    def aifi(self, node, x):
        b, c, h, w = x.shape
        src = x.flatten(2).transpose(1, 2)
        qk = src + self.sincos(h, w, c, x.device)
        src = self.norm(node["norm1"], src + self.attention(node["attn"], qk,
                                                            qk, src))
        ff = self.dense(node["fc2"], F.gelu(self.dense(node["fc1"], src)))
        src = self.norm(node["norm2"], src + ff)
        return src.transpose(1, 2).reshape(b, c, h, w)

    def repc3(self, node, x):
        y = self.conv(node["cv1"], x, act="silu")
        i = 0
        while f"m{i}" in node:
            m = node[f"m{i}"]
            a = self.conv(m["conv1"], y)
            b = self.conv(m["conv2"], y, pad=0)
            y = F.silu(a + b)
            i += 1
        return y + self.conv(node["cv2"], x, act="silu")

    def encoder(self, p3, p4, p5):
        e = self.p["encoder"]
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest")
        y5 = self.conv(e["lat0"], self.aifi(e["aifi"], self.conv(e["proj2"],
                                                                 p5)),
                       act="silu")
        y4 = self.conv(e["lat1"], self.repc3(e["fpn0"], torch.cat(
            [up(y5), self.conv(e["proj1"], p4)], 1)), act="silu")
        x3 = self.repc3(e["fpn1"], torch.cat([up(y4),
                                              self.conv(e["proj0"], p3)], 1))
        f4 = self.repc3(e["pan0"], torch.cat(
            [self.conv(e["down0"], x3, 2, act="silu"), y4], 1))
        f5 = self.repc3(e["pan1"], torch.cat(
            [self.conv(e["down1"], f4, 2, act="silu"), y5], 1))
        return x3, f4, f5

    # --- decoder ------------------------------------------------------------

    def memory(self, maps):
        d = self.p["decoder"]
        feats, shapes = [], []
        for i, m in enumerate(maps):
            m = self.conv(d[f"proj{i}"], m)
            shapes.append((m.shape[2], m.shape[3]))
            feats.append(m.flatten(2).transpose(1, 2))
        return torch.cat(feats, 1), shapes

    @staticmethod
    def anchors(shapes, device, grid=0.05, eps=0.01):
        rows = []
        for lvl, (h, w) in enumerate(shapes):
            for y in range(h):
                for x in range(w):
                    rows.append(((x + 0.5) / w, (y + 0.5) / h,
                                 grid * 2.0 ** lvl, grid * 2.0 ** lvl))
        a = torch.tensor(rows, dtype=torch.float32, device=device)
        valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdim=True)
        return torch.where(valid, torch.log(a / (1 - a)),
                           torch.full_like(a, float("inf"))), valid

    def encoder_scores(self, feats, shapes):
        """The encoder's memory after ``enc_output`` and its class logits
        over every anchor."""
        d = self.p["decoder"]
        _, valid = self.anchors(shapes, feats.device)
        mem = self.norm(d["enc_norm"], self.dense(d["enc_linear"],
                                                  feats * valid))
        return mem, self.dense(d["enc_score"], mem)

    def select(self, feats, shapes, index=None):
        """Query selection: the top ``num_queries`` anchors by their best
        class logit (``index`` given: those); ``(embed, ref_logit,
        index)``."""
        d = self.p["decoder"]
        anchors, _ = self.anchors(shapes, feats.device)
        mem, logits = self.encoder_scores(feats, shapes)
        if index is None:
            index = torch.topk(logits.max(-1).values, self.num_queries,
                               dim=1).indices
        bi = torch.arange(len(index), device=index.device)[:, None]
        top = mem[bi, index]
        return top, self.mlp(d["enc_bbox"], top) + anchors[index], index

    def msda(self, node, query, ref, feats, shapes, heads=8, levels=3,
             points=4):
        b, q, d = query.shape
        dh = d // heads
        value = self.dense(node["value"], feats).reshape(b, -1, heads, dh)
        off = self.dense(node["offsets"], query).reshape(
            b, q, heads, levels, points, 2)
        aw = torch.softmax(self.dense(node["weights"], query).reshape(
            b, q, heads, levels * points), -1).reshape(
            b, q, heads, levels, points)
        loc = ref[:, :, None, None, None, :2] \
            + off / points * ref[:, :, None, None, None, 2:] * 0.5
        grid = 2 * loc - 1
        out = torch.zeros(b, q, heads, dh, device=query.device)
        start = 0
        for lvl, (h, w) in enumerate(shapes):
            v = value[:, start:start + h * w]           # (B, hw, H, dh)
            start += h * w
            v = v.permute(0, 2, 3, 1).reshape(b * heads, dh, h, w)
            g = grid[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
                b * heads, q, points, 2)
            s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                              align_corners=False)       # (BH, dh, q, P)
            s = s.reshape(b, heads, dh, q, points).permute(0, 3, 1, 4, 2)
            out = out + (s * aw[:, :, :, lvl, :, None]).sum(3)
        return self.dense(node["out"], out.reshape(b, q, d))

    def layers(self, embed, ref_logit, feats, shapes):
        d = self.p["decoder"]
        x = embed
        ref = torch.sigmoid(ref_logit)
        n = sum(1 for k in d if k.startswith("layer"))
        for i in range(n):
            node = d[f"layer{i}"]
            pos = self.mlp(d["query_pos"], ref)
            qk = x + pos
            x = self.norm(node["norm1"], x + self.attention(node["attn"], qk,
                                                            qk, x))
            x = self.norm(node["norm2"], x + self.msda(node["msda"], x + pos,
                                                       ref, feats, shapes))
            ff = self.dense(node["fc2"], torch.relu(self.dense(node["fc1"],
                                                               x)))
            x = self.norm(node["norm3"], x + ff)
            r = ref.clamp(0, 1)
            inv = torch.log(r.clamp(min=1e-5) / (1 - r).clamp(min=1e-5))
            ref = torch.sigmoid(self.mlp(d[f"bbox{i}"], x) + inv)
        return ref, self.dense(d[f"score{n - 1}"], x)

    def __call__(self, x):
        feats, shapes = self.memory(self.encoder(*self.backbone(x)))
        embed, ref, _ = self.select(feats, shapes)
        return self.layers(embed, ref, feats, shapes)
