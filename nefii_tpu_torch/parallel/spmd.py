"""The sharded step and render (counterpart of nefii_tpu/parallel/spmd.py),
as plain functions on tensors: each process holds the whole parameters and
its contiguous slice of the batch.

  * `shard_batch` cuts the pixel batch as the JAX package's batch_pspec
    does: uv, object_mask, rgb and pixel_visible on axis 1, points and
    ray_dirs on axis 0, everything else whole (`shard` cuts one array).
  * `loss_all_reduce` is IDRLoss's hook: each masked mean's (numerator,
    denominator) pair summed over the processes before the division, so the
    loss is the loss of the whole batch on every rank. Its backward passes
    the gradient through unchanged: each rank's gradient is then that of
    the whole batch's loss with respect to its own slice's terms, and
    `all_reduce_grads` sums those into the gradient of the whole batch,
    exactly (JAX's psum'd pairs, whose transpose in shard_map does the
    same). `torch.distributed.nn.functional.all_reduce` would sum the
    gradient over the ranks in its backward too (W times too large), and
    DDP averages the ranks' own means (the mean of means) -- neither is
    this gradient.
  * `eval_forward` renders a chunk: each rank its slice, the outputs
    gathered along the pixel axis in rank order (make_eval_forward).
  * `rank_seed` seeds a rank's generator: rank 0's stream is the single
    process's, the others' differ (JAX folds its key with the axis index).

With one process every function is the identity of the single-process
port: nothing is cut, reduced or gathered.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from nefii_tpu_torch.parallel import dist

# keys sharded along their pixel axis (axis 1 for [B,S,...], axis 0 for flat)
BATCH_AXIS1 = ("uv", "object_mask", "rgb", "pixel_visible")
BATCH_AXIS0 = ("points", "ray_dirs")

# a rank's generator seed is seed + RANK_STRIDE * rank
RANK_STRIDE = 1_000_003


def rank_seed(seed: int, rank: Optional[int] = None) -> int:
    return seed + RANK_STRIDE * (dist.rank() if rank is None else rank)


def shard(x, axis: int = 0, rank: Optional[int] = None, world: Optional[int] = None,
          name: str = "array"):
    """This rank's contiguous slice of `x` (a tensor or numpy array) along
    `axis`. Raises ValueError when the axis does not divide by the world."""
    rank = dist.rank() if rank is None else rank
    world = dist.process_count() if world is None else world
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"shard_batch: {name!r} has {n} on axis {axis}, which does not divide "
                         f"by {world} processes (shape {tuple(x.shape)})")
    step = n // world
    sl = [slice(None)] * (axis + 1)
    sl[axis] = slice(rank * step, (rank + 1) * step)
    return x[tuple(sl)]


def shard_batch(batch: Dict, rank: Optional[int] = None, world: Optional[int] = None) -> Dict:
    """This rank's contiguous slice of every sharded key of `batch` (tensors
    or numpy arrays); the other keys whole. Raises ValueError when a sharded
    axis does not divide by the world size."""
    world = dist.process_count() if world is None else world
    if world == 1:
        return batch
    return {k: shard(v, 1 if k in BATCH_AXIS1 else 0, rank, world, k)
            if k in BATCH_AXIS1 or k in BATCH_AXIS0 else v for k, v in batch.items()}


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of x over the ranks. Backward: the gradient, as it
    comes (the module docstring)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce_sum(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def _sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    return _SumOverRanks.apply(x)


def loss_all_reduce() -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """IDRLoss's `all_reduce` hook for this world: None for one process."""
    return _sum_over_ranks if dist.process_count() > 1 else None


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum the parameters' .grad over the ranks in one flat bucket (a
    missing gradient counts as zeros and becomes one)."""
    params = list(params)
    if dist.process_count() == 1 or not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce_sum(flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p).clone()


@torch.no_grad()
def eval_forward(model, batch: Dict[str, torch.Tensor], gen: torch.Generator,
                 keys: Iterable[str]) -> Dict:
    """The eval render of a chunk sharded over the ranks: each renders its
    slice of `batch` (shard_batch) and gets the `keys` of the whole chunk,
    in pixel order, and `n_sdf_evals`, the SDF evaluations of every rank
    (every rank must call it: it gathers)."""
    out = model.forward_with_uv(shard_batch(batch), gen)
    res = {k: dist.gather_along(out[k], 0) for k in keys}
    n = int(out["n_sdf_evals"])
    if dist.process_count() > 1:
        n = int(dist.all_reduce_sum(torch.tensor([n], dtype=torch.int64,
                                                 device=batch["uv"].device)))
    res["n_sdf_evals"] = n
    return res
