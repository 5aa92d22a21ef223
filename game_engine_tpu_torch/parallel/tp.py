"""Tensor parallelism of the policy trunk: the collectives GSPMD inserts
for params_sharding's column/row split, as autograd functions over a
mesh's model group.

  copy_to_model      identity forward, sum over the model group backward:
                     the replicated input of a column-split (even) layer,
                     whose slices each give part of its gradient
  reduce_from_model  sum over the model group forward, identity backward:
                     the f32 partial products of a row-split (odd) layer
  gather_from_model  the model group's column slices concatenated forward,
                     this rank's columns of the gradient backward: the
                     output of a last even layer, before the replicated
                     heads
"""

from __future__ import annotations

import torch


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_sum(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.cols = (mesh.model_index * x.shape[-1], (mesh.model_index + 1) * x.shape[-1])
        return mesh.model_gather(x, -1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.cols
        return g[..., lo:hi].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh)
