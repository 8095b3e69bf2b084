"""Parameter trees: nested dicts of tensors, walked in the JAX pytree order
(sorted keys), and their carry-over to and from numpy.

The port keeps the JAX parameter tree as it is (same nested keys, same
shapes, the stacked leading layer axis), so a tree initialised by the JAX
package converts leaf by leaf: ``params_from_numpy(jax.tree.map(np.asarray,
params))``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from tpudra_torch.workload.device import resolve_device


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of same-shaped trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in sorted-key order."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def params_from_numpy(tree: Any, device: str | torch.device | None = None) -> Any:
    """A tree of numpy arrays (e.g. the JAX parameter tree through
    ``np.asarray``) as tensors on ``device`` (default CUDA), dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """The reverse of ``params_from_numpy``: detached f32/int host copies.
    bf16 leaves come back as float32 (numpy has no bfloat16)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)
