"""The one traffic generator: reads a traffic mix's file and makes its
batches from the run's seed.

A training mix gives the sequence length ``seq``, the rows a step
``batch``, how many distinct batches the pool holds ``pool`` and the steps
between two reads of the loss ``loss_every``.  Tokens are uniform over the
vocabulary: every seed gives the same sizes, only the values differ.
"""

from __future__ import annotations

import torch

TRAIN_KEYS = {"seq", "batch", "pool", "loss_every"}
# The token stream's seed is set apart from the weights' seed.
_TOKEN_STREAM = 0x9E3779B97F4A7C15


def check_traffic(traffic: dict, first_steps: int) -> None:
    """Raise unless ``traffic`` is a training mix this generator reads, with
    more batches in its pool than the ``first_steps`` that set-up drives."""
    if set(traffic) != TRAIN_KEYS:
        raise ValueError(f"a training mix has exactly the keys {sorted(TRAIN_KEYS)}, "
                         f"got {sorted(traffic)}")
    for key in TRAIN_KEYS:
        if not (isinstance(traffic[key], int) and traffic[key] > 0):
            raise ValueError(f"traffic {key} must be a positive whole number, got {traffic[key]!r}")
    if traffic["seq"] < 2 or traffic["pool"] <= first_steps:
        raise ValueError("traffic needs seq >= 2 and more pool batches than checked steps")


def token_pool(traffic: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """[pool, batch, seq] int64 tokens, uniform over [0, vocab), from ``seed``,
    made on ``device`` in one call."""
    gen = torch.Generator(device=device).manual_seed((seed + _TOKEN_STREAM) % 2**64)
    shape = (traffic["pool"], traffic["batch"], traffic["seq"])
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def tokens_per_step(traffic: dict) -> int:
    """Tokens trained a step: each row predicts seq − 1 next tokens."""
    return traffic["batch"] * (traffic["seq"] - 1)
