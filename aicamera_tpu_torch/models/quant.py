"""Post-training int8 quantization (W8A8) of the ReID embedder.

The port of ``aicamera_tpu/models/quant.py``: the same scheme, standard
dynamic-range W8A8 with no calibration data.

* **Weights**: per-output-channel symmetric int8, ``scale = max|w| / 127``,
  computed once with numpy exactly as the JAX package does, so the int8
  weights and scales are bitwise JAX's from the same f32 weights.
* **Activations**: per-sample dynamic symmetric int8: each crop's conv input
  is scaled by its own ``max|x| / 127``.
* **Accumulation**: :func:`int8_conv`, an int8 x int8 -> int32 product
  (``torch._int_mm``, cuBLASLt on the GPU) over an im2col matrix built from
  shifted int8 slices, then one f32 dequant-scale + bias (+ ReLU). Residual
  adds and the global average pool and L2 norm stay f32.

:class:`QuantReIDNet` is an ``nn.Module`` over the quantized tree (the JAX
package's keys: ``stem``, ``block{i}.cv1/cv2[/proj]``, ``fc`` when present)
with the float net's contract: ``(B, H, W, 3)`` normalized crops ->
``(B, feature_dim)`` L2-normalized f32 features.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["quantize_reid_params", "QuantReIDNet", "quantize_conv",
           "int8_conv", "QConv", "fma"]

# ReIDNet's residual stage plan (models/reid.py) — (features, downsample)
# per block; a block whose channel count changes has a 1x1 projection.
_REID_BLOCKS = [(64, False), (64, False),
                (128, True), (128, False),
                (256, True), (256, False),
                (512, True), (512, False)]

_MIN_ROWS = 17  # cuBLASLt's int8 product takes more than 16 rows


def quantize_conv(kernel: np.ndarray, bias: np.ndarray) -> dict:
    """f32 HWIO kernel + bias -> ``{'w': int8 HWIO, 'scale': (O,), 'bias'}``
    as CPU tensors. Per-output-channel symmetric: ``scale_o = max|w[..., o]|
    / 127``; numpy, the JAX package's arithmetic."""
    w = np.asarray(kernel, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))  # (O,)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"w": torch.from_numpy(q),
            "scale": torch.from_numpy(np.asarray(scale, np.float32)),
            "bias": torch.from_numpy(np.array(bias, np.float32))}


def _flax_params(params) -> dict:
    """The Flax-layout params tree of a module or a tree."""
    if isinstance(params, nn.Module):
        from ..runtime.params import flax_tree
        params = flax_tree(params)
    return params["params"] if "params" in params else params


def quantize_reid_params(params) -> dict:
    """Quantize a ReID net (a ``models.reid.ReIDNet`` or its Flax params
    tree): a tree of :func:`quantize_conv` entries keyed like the source
    modules, ``stem``, ``block{i}.cv1/cv2[/proj]`` (+ ``fc`` passed through
    in f32 when present)."""
    p = _flax_params(params)

    def conv_of(tree):
        # _ConvBNRelu nests its conv under 'conv'; a bare conv does not
        t = tree["conv"] if "conv" in tree else tree
        return quantize_conv(t["kernel"], t["bias"])

    out = {"stem": conv_of(p["stem"])}
    for i in range(len(_REID_BLOCKS)):
        b = p[f"block{i}"]
        qb = {"cv1": conv_of(b["cv1"]), "cv2": conv_of(b["cv2"])}
        if "proj" in b:
            qb["proj"] = conv_of(b["proj"])
        out[f"block{i}"] = qb
    if "fc" in p:
        out["fc"] = {k: torch.from_numpy(np.array(p["fc"][k], np.float32))
                     for k in ("kernel", "bias")}
    return out


def gemm_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """An int8 HWIO kernel as :func:`int8_conv`'s ``(O8, K8)`` matrix: rows
    the output channels, columns ``(kh, kw, cin)`` as the im2col columns,
    both padded with zeros to multiples of 8 (cuBLASLt's int8 product)."""
    kh, kw, cin, cout = w_hwio.shape
    k = kh * kw * cin
    wm = w_hwio.reshape(k, cout).t()
    return F.pad(wm, (0, -k % 8, 0, -cout % 8)).contiguous()


def int8_conv(xq: torch.Tensor, wmat: torch.Tensor, kh: int, kw: int,
              stride: int, pad: int, n_out: int) -> torch.Tensor:
    """int8 NHWC ``(B, H, W, C)`` convolved with :func:`gemm_weight`'s
    matrix -> exact int32 NHWC ``(B, Ho, Wo, n_out)``.

    The im2col matrix is built from shifted, strided int8 slices of the
    zero-padded input (no float detour), padded to the matrix's depth, and
    multiplied with ``torch._int_mm`` (int32 accumulation: exact, so the
    card and the CPU agree bitwise)."""
    b, h, w, c = xq.shape
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    cols = [xq[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    k = kh * kw * c
    if wmat.shape[1] > k:
        cols.append(xq.new_zeros((b, ho, wo, wmat.shape[1] - k)))
    a = torch.cat(cols, dim=-1).reshape(b * ho * wo, wmat.shape[1])
    m = a.shape[0]
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    y = torch._int_mm(a, wmat.t())
    return y[:m, :n_out].reshape(b, ho, wo, n_out)


class QConv(nn.Module):
    """One quantized convolution's buffers: the int8 HWIO kernel ``w``, the
    per-output-channel ``scale``, the ``bias`` and the GEMM matrix."""

    def __init__(self, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, stride: int = 1):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        self.register_buffer("wmat", gemm_weight(w), persistent=False)
        self.kh, self.kw = int(w.shape[0]), int(w.shape[1])
        self.n_out = int(w.shape[3])
        self.stride = stride

    def accumulate(self, xq: torch.Tensor, stride: int | None = None
                   ) -> torch.Tensor:
        """int8 NHWC -> the int32 accumulators (SAME padding ``k // 2``;
        ``stride`` default the module's)."""
        return int8_conv(xq, self.wmat, self.kh, self.kw,
                         stride or self.stride, self.kh // 2, self.n_out)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (in float64), the multiply-add that
    XLA's CPU backend fuses in the JAX package's dequant epilogues: with it
    the port's epilogues equal JAX's bitwise."""
    return (a.double() * b.double() + c.double()).float()


def _qconv(x: torch.Tensor, q: QConv) -> torch.Tensor:
    """Dynamic-int8 conv: per-sample activation quant, int8 product, f32
    dequant + bias. ``x`` is ``(B, H, W, C)`` f32."""
    ax = torch.amax(torch.abs(x), dim=(1, 2, 3), keepdim=True)  # (B,1,1,1)
    # ``/ 127.0`` as XLA computes it: a product by the f32 reciprocal
    s = torch.clamp(ax, min=1e-12) * float(np.float32(1.0 / 127.0))
    xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    y = q.accumulate(xq)
    return fma(y.float(), s * q.scale, q.bias)


class QuantReIDNet(nn.Module):
    """The int8 twin of ``models.reid.ReIDNet`` over a
    :func:`quantize_reid_params` tree (the JAX package's ``QuantReIDNet``
    with its ``qparams`` bound): ``(B, H, W, 3)`` normalized crops ->
    ``(B, feature_dim)`` L2-normalized f32 features, cosine-compatible with
    the float net's."""

    def __init__(self, qparams: dict, feature_dim: int = 512):
        super().__init__()
        self.feature_dim = feature_dim
        # the input dtype callers prepare (crops stay f32; int8 lives only
        # inside the forward)
        self.dtype = torch.float32
        self.stem = QConv(**qparams["stem"])
        for i, (_, down) in enumerate(_REID_BLOCKS):
            qb, s = qparams[f"block{i}"], 2 if down else 1
            block = nn.Module()
            block.cv1 = QConv(**qb["cv1"], stride=s)
            block.cv2 = QConv(**qb["cv2"])
            block.proj = QConv(**qb["proj"], stride=s) if "proj" in qb \
                else None
            self.add_module(f"block{i}", block)
        self.fc = None
        if "fc" in qparams:
            self.fc = nn.Module()
            for k in ("kernel", "bias"):
                self.fc.register_buffer(k, qparams["fc"][k])

    def qparams(self) -> dict:
        """The quantized tree, as numpy (the JAX package's keys)."""
        def leaf(q):
            return {k: getattr(q, k).cpu().numpy()
                    for k in ("w", "scale", "bias")}
        out = {"stem": leaf(self.stem)}
        for i in range(len(_REID_BLOCKS)):
            b = getattr(self, f"block{i}")
            out[f"block{i}"] = {n: leaf(getattr(b, n)) for n in
                                ("cv1", "cv2", "proj")
                                if getattr(b, n) is not None}
        if self.fc is not None:
            out["fc"] = {k: getattr(self.fc, k).cpu().numpy()
                         for k in ("kernel", "bias")}
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_qconv(x.float(), self.stem))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)  # -inf padding
        for i in range(len(_REID_BLOCKS)):
            b = getattr(self, f"block{i}")
            y = F.relu(_qconv(x, b.cv1))
            y = _qconv(y, b.cv2)
            if b.proj is not None:
                x = _qconv(x, b.proj)
            x = F.relu(x + y)
        x = torch.mean(x, dim=(1, 2))  # (B, 512) f32
        if self.fc is not None:
            x = x @ self.fc.kernel + self.fc.bias
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=1e-7)
