"""The process groups of a ("dp", "sp", "tp") or ("pp", "dp"[, "tp"]) layout,
and the autograd-aware collectives that run the model on local shards.

The JAX package writes the model once and lets GSPMD partition it.  The port
runs each rank's share of the same math on plain local tensors (the flash
attention and fused CE kernels are autograd Functions on plain tensors,
which DTensor cannot dispatch) and places the collectives by hand, in
Megatron's form:

- ``copy_to``      (Megatron's f): identity forward, all-reduce backward, at
                   the input of a column-parallel product;
- ``reduce_from``  (Megatron's g): all-reduce forward, identity backward, at
                   the output of a row-parallel product;
- ``gather``:      all-gather forward; backward either this rank's slice of
                   the gradient (every rank computed the same thing after the
                   gather, so each holds the whole gradient) or a
                   reduce-scatter (each rank computed on its own share of
                   the rows, so each holds a part of it);
- ``mean_over``:   all-reduce mean both ways (a statistic every rank needs
                   over all ranks' tokens, such as the MoE load fractions);
- ``ppermute``:    each rank's tensor to the next rank of a ring forward, the
                   gradient back to the previous one (ring attention's
                   rotation, the pipeline's stage-to-stage hand-over).

Every op is the identity when its group is None: the single-device model is
the same code with no groups.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Groups:
    """The process groups a rank's shard of the model talks over; all None
    for one device with no mesh.

    dp: token batch sharded, params replicated (gradients averaged over it);
    sp: the sequence sharded inside the model (ring attention's blocks; the
        plain sharded step gathers the sequence and runs the model without);
    tp: params sharded in the Megatron layout, experts sharded (MoE);
    pp: the layer stack split into pipeline stages."""

    dp: Optional[dist.ProcessGroup] = None
    sp: Optional[dist.ProcessGroup] = None
    tp: Optional[dist.ProcessGroup] = None
    pp: Optional[dist.ProcessGroup] = None

    @classmethod
    def from_mesh(cls, mesh, axes: tuple[str, ...]) -> "Groups":
        """The groups of those of ``axes`` that ``mesh`` has, by name; None
        for the rest.  Each step names the axes its model runs over."""
        return cls(**{name: mesh.get_group(name) for name in axes
                      if name in mesh.mesh_dim_names})


def mesh_shape(mesh) -> dict[str, int]:
    """{dim name: size} of a ``DeviceMesh``, as jax's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def size_and_rank(group) -> tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


# torch 2.13 deprecates the two *_tensor calls in favour of *_single, which
# torch 2.11 lacks; both versions have these.
def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, group=group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


# The gathers and scatters below work on dim 0 and hand back contiguous
# tensors: a strided result would make the ops after them reduce in another
# order than the single-device model does (an RMSNorm's mean over a strided
# row rounds differently), which a router near-tie turns into another expert.
def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All ranks' ``x`` concatenated along ``dim``, in rank order."""
    n, _ = size_and_rank(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    all_gather_into(out, x, group)
    return out.movedim(0, dim).contiguous()


def _slice_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = size_and_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {n} ranks")
    return x.chunk(n, dim)[r]


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, _ = size_and_rank(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    reduce_scatter_into(out, x, group)
    return out.movedim(0, dim).contiguous()


def ring_shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Rank r's ``x`` at rank r + shift (mod n) of ``group``'s ring (more
    than one rank): one send and one receive each, batched."""
    n, r = size_and_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial_grads):
        ctx.group, ctx.dim, ctx.partial_grads = group, dim, partial_grads
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial_grads:
            return _reduce_scatter_dim(g, ctx.group, ctx.dim), None, None, None
        return _slice_dim(g, ctx.group, ctx.dim), None, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group) / dist.get_world_size(ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -ctx.shift), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``group``; its gradient as it is."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, group, dim: int, partial_grads: bool) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``.  Backward: this rank's
    slice of the gradient, summed over the group first where each rank's
    gradient is only a part (``partial_grads``: reduce-scatter)."""
    return x if group is None else _Gather.apply(x, group, dim, partial_grads)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``, both ways (the gradient too)."""
    return x if group is None else _MeanOver.apply(x, group)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over the ring of ``group``: rank r's ``x`` arrives at
    rank r + shift (mod n); the gradient goes back by -shift.  A group of
    one is the identity.  Every rank of the group must call it in the same
    order, and so must the backward: ranks that build the same graph do."""
    if group is None or size_and_rank(group)[0] == 1:
        return x
    return _PPermute.apply(x, group, shift)


def distribute_local(full: torch.Tensor, mesh, placements):
    """``full`` (the same on every rank) as a DTensor with ``placements``
    over ``mesh``, each rank slicing its own shard (no communication) into a
    tensor of its own.  Shards must be equal: a sharded dim divides by its
    mesh dim's size."""
    from torch.distributed.tensor import DTensor, Shard

    local = full
    for mesh_dim, placement in enumerate(placements):
        if isinstance(placement, Shard):
            n = mesh.size(mesh_dim)
            if local.shape[placement.dim] % n:
                raise ValueError(
                    f"dim {placement.dim} of {tuple(full.shape)} does not divide over "
                    f"{n} ranks of mesh dim {mesh_dim}"
                )
            local = local.chunk(n, placement.dim)[mesh.get_local_rank(mesh_dim)]
    return DTensor.from_local(
        local.clone(memory_format=torch.contiguous_format), mesh, placements,
        run_check=False, shape=full.shape, stride=full.stride(),
    )


def local_tree(tree):
    """Each DTensor leaf's local shard (the tensor itself, so in-place
    updates land in the DTensor)."""
    from tpudra_torch.workload.convert import tree_map

    with torch.no_grad():
        return tree_map(lambda d: d.to_local(), tree)
