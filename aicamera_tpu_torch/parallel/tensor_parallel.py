"""Tensor parallelism for the detector: convolutions split by output channel.

The port of ``aicamera_tpu/parallel/tensor_parallel.py``. There, the conv
kernels' output-channel dimension is placed on the mesh's ``model`` axis and
GSPMD splits every conv and inserts the collectives. Here the split is
explicit: :func:`shard_detector_params` swaps every convolution whose
output channels divide the axis for a :class:`ChannelParallelConv2d` that
holds only this rank's ``out / n`` channels of the weight and bias,
computes them on the full input, and restores the full activation with one
all-gather over the ``model`` group (the collective GSPMD inserts). A
convolution whose output channels do not divide stays whole on every rank
(replicated; the JAX package's rule, ``_spec_for``).

DTensor's own convolution is not used: PyTorch registers one sharding
strategy for ``aten.convolution`` (a batch-sharded input with a replicated
weight), so a ``Shard(0)`` weight would be all-gathered and the whole conv
run on every rank. The placements are recorded all the same, as DTensor
placements (``Shard(0)``, ``Replicate()``) of each parameter on the mesh's
``model`` dimension, in ``module.tp_placements``.

Inference only, as in the JAX package.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import layout
from .distributed import COLLECTIVES, rank_device


class ChannelParallelConv2d(nn.Module):
    """This rank's block of a conv's output channels, all-gathered."""

    def __init__(self, conv: nn.Conv2d, group, index: int, n: int):
        super().__init__()
        c = conv.out_channels // n
        sl = slice(index * c, (index + 1) * c)
        self.weight = nn.Parameter(conv.weight.detach()[sl].clone(),
                                   requires_grad=False)
        self.bias = (None if conv.bias is None else nn.Parameter(
            conv.bias.detach()[sl].clone(), requires_grad=False))
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self.out_channels = conv.out_channels
        self.group, self.n = group, n

    def forward(self, x):
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        # gathered in the activation's memory order (models/layers.py):
        # rows (B, h, w, c) channels-last, (B, c, h, w) NCHW; no copy of a
        # y in its layout
        nhwc = layout(y.dtype) == torch.channels_last
        rows = (y.permute(0, 2, 3, 1) if nhwc else y).contiguous()
        out = torch.empty((self.n, *rows.shape), dtype=y.dtype,
                          device=y.device)
        COLLECTIVES.all_gather_into_tensor(out.view(-1, *rows.shape[1:]),
                                           rows, group=self.group)
        # (rank, B, ..., c, ...) -> (B, ..., rank * c, ...): rank r's block
        # of channels lands where the whole conv writes it
        cdim = 3 if nhwc else 1
        full = out.movedim(0, cdim).flatten(cdim, cdim + 1)
        return full.permute(0, 3, 1, 2) if nhwc else full


def _placements(module: nn.Module):
    from torch.distributed.tensor import Replicate, Shard
    out = {}
    for name, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            out[f"{name}.{pname}" if name else pname] = (
                Shard(0) if isinstance(mod, ChannelParallelConv2d)
                else Replicate())
    return out


def _on_mesh(model: nn.Module, mesh) -> nn.Module:
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    dev = rank_device()
    if dev.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but this "
                         f"rank's device is {dev}")
    return copy.deepcopy(model).to(dev)


def shard_detector_params(model: nn.Module, mesh, axis: str = "model"):
    """A copy of ``model`` (the detector, or one of its stages) on this
    rank's device, every ``nn.Conv2d`` whose output channels divide the
    size of ``mesh``'s ``axis`` split over that axis (none at size 1). Its
    placements are in ``.tp_placements`` (parameter name -> ``Shard(0)``
    or ``Replicate()`` on ``axis``)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (axes {names})")
    n = mesh.size(names.index(axis))
    index = mesh.get_local_rank(axis)
    model = _on_mesh(model, mesh)
    group = mesh.get_group(axis)
    for mod in list(model.modules()):
        for child_name, child in list(mod.named_children()):
            if isinstance(child, nn.Conv2d) and n > 1 \
                    and child.out_channels % n == 0:
                setattr(mod, child_name,
                        ChannelParallelConv2d(child, group, index, n))
    model.tp_placements = _placements(model)
    return model


def replicate_params(model: nn.Module, mesh):
    """A copy of ``model`` whole on this rank's device (the data-parallel
    default), every placement ``Replicate()``."""
    model = _on_mesh(model, mesh)
    model.tp_placements = _placements(model)
    return model


def sharded_convs(model: nn.Module) -> int:
    """How many channel-parallel convolutions ``model`` runs (one
    all-gather each a forward)."""
    return sum(isinstance(m, ChannelParallelConv2d) for m in model.modules())
