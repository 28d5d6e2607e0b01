"""Weights the benchmark hands to the program and to the reference.

``embedded_yolo``: a YOLOv8 of larger widths and depth whose function is a
trained smaller one. Every weight is drawn on the device from the seed
(fan-in-scaled normals, one draw for the whole model), then the trained
model is written into the leading channels: each trained conv's kernel and
bias go to the channels its input and output map to, and the weights that
read an added channel into a mapped one are set to 0. Added channels and
added C2f repeats compute seeded values that no mapped channel reads, so
the outputs are the trained model's in exact arithmetic, while every layer
does the larger model's work. Seeded weights alone put nearly every score
near a threshold (see ``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from .yardstick import arch


def _prefix(n):
    return np.arange(n)


class _Embed:
    def __init__(self, small: dict, big: dict):
        self.s, self.b = small, big   # trees of tensors (HWIO), same keys

    def conv(self, path, imap):
        """Write the small conv at ``path`` into the big one, inputs mapped
        by ``imap``; returns the output map (a prefix)."""
        s = self._node(self.s, path)
        omap = _prefix(s["kernel"].shape[-1])
        self._write(self._node(self.b, path), s, imap, omap)
        return omap

    @staticmethod
    def _write(b, s, imap, omap):
        """The small node ``s`` into the big node ``b``: input channel
        ``i`` of ``s`` is ``imap[i]`` of ``b``, output ``o`` is
        ``omap[o]``; what the mapped outputs read from unmapped inputs is
        zeroed."""
        ws, wb = s["kernel"], b["kernel"]
        cin = wb.shape[-2]
        pad = np.setdiff1d(np.arange(cin), imap)
        o = torch.as_tensor(omap, device=wb.device)
        if len(pad):
            p = torch.as_tensor(pad, device=wb.device)
            sub = wb[..., o]
            sub[..., p, :] = 0
            wb[..., o] = sub
        i = torch.as_tensor(imap, device=wb.device)
        sub = wb[..., o]
        sub[..., i, :] = ws
        wb[..., o] = sub
        b["bias"][o] = s["bias"]

    @staticmethod
    def _node(tree, path):
        """The conv node at ``path`` (a block's ``conv``, or a bare conv)."""
        node = _Embed._node_raw(tree, path)
        return node.get("conv", node)

    def c2f(self, path, imap):
        s = self._node_raw(self.s, path)
        b = self._node_raw(self.b, path)
        cs = s["cv1"]["conv"]["kernel"].shape[-1] // 2
        cb = b["cv1"]["conv"]["kernel"].shape[-1] // 2
        omap = np.concatenate([_prefix(cs), cb + _prefix(cs)])
        self._write(b["cv1"]["conv"], s["cv1"]["conv"], imap, omap)
        n_s = sum(1 for k in s if k.startswith("m") and k[1:].isdigit())
        for i in range(n_s):
            self.conv(path + (f"m{i}", "cv1"), _prefix(cs))
            self.conv(path + (f"m{i}", "cv2"), _prefix(cs))
        cat = np.concatenate([j * cb + _prefix(cs) for j in range(2 + n_s)])
        return self.conv(path + ("cv2",), cat)

    @staticmethod
    def _node_raw(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def sppf(self, path, imap):
        h = self.conv(path + ("cv1",), imap)
        cb = self._node(self.b, path + ("cv1",))["kernel"].shape[-1]
        return self.conv(path + ("cv2",),
                         np.concatenate([j * cb + h for j in range(4)]))

    def width(self, path):
        return self._node(self.b, path)["kernel"].shape[-1]

    def run(self):
        B, N, H = ("backbone",), ("neck",), ("head",)
        x = self.conv(B + ("stem",), _prefix(3))
        x = self.c2f(B + ("c2f1",), self.conv(B + ("down1",), x))
        p3 = self.c2f(B + ("c2f2",), self.conv(B + ("down2",), x))
        p4 = self.c2f(B + ("c2f3",), self.conv(B + ("down3",), p3))
        p5 = self.sppf(B + ("sppf",), self.c2f(
            B + ("c2f4",), self.conv(B + ("down4",), p4)))
        w5 = self.width(B + ("sppf", "cv2"))
        t1 = self.c2f(N + ("up_c2f1",), np.concatenate([p5, w5 + p4]))
        wt1 = self.width(N + ("up_c2f1", "cv2"))
        n3 = self.c2f(N + ("up_c2f2",), np.concatenate([t1, wt1 + p3]))
        d1 = self.conv(N + ("down_conv1",), n3)
        wd1 = self.width(N + ("down_conv1",))
        n4 = self.c2f(N + ("down_c2f1",), np.concatenate([d1, wd1 + t1]))
        d2 = self.conv(N + ("down_conv2",), n4)
        wd2 = self.width(N + ("down_conv2",))
        n5 = self.c2f(N + ("down_c2f2",), np.concatenate([d2, wd2 + p5]))
        for i, f in enumerate((n3, n4, n5)):
            for kind in ("reg", "cls"):
                h = self.conv(H + (f"{kind}{i}_cv1",), f)
                h = self.conv(H + (f"{kind}{i}_cv2",), h)
                self.conv(H + (f"{kind}{i}_out",), h)


def _to_tensors(tree, device):
    return {k: _to_tensors(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def _seeded(shapes: dict, seed: int, device) -> dict:
    """Fan-in-scaled normal kernels and zero biases, one draw from the
    seed on ``device``."""
    flat = list(arch.leaves(shapes))
    total = sum(int(np.prod(s)) for path, s in flat if path[-1] == "kernel")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for path, shape in flat:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path[-1] == "kernel":
            n = int(np.prod(shape))
            fan_in = n // shape[-1]
            node["kernel"] = draw[at:at + n].view(shape) * fan_in ** -0.5
            at += n
        else:
            node["bias"] = torch.zeros(shape, device=device)
    return out


def embedded_yolo(small_tree: dict, shapes: dict, seed: int,
                  device) -> dict:
    """The larger model's Flax tree (numpy, ``{"params": ...}``) with the
    trained ``small_tree`` embedded; see the module's docstring."""
    big = _seeded(shapes, seed, device)
    small = _to_tensors(small_tree["params"], device)
    _Embed(small, big["params"]).run()
    return {"params": _to_numpy(big["params"])}


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}
