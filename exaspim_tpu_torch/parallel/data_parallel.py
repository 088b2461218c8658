"""Data-parallel training over a mesh.

Counterpart of ``exaspim_tpu/parallel/data_parallel.py``. In the JAX
package the batch axis is sharded over the mesh and XLA inserts the
gradient all-reduce. Here every rank draws the same global batch, takes
its contiguous share (:func:`shard_batch`), runs forward and backward on
it, and the gradients are all-reduced over the mesh to the global mean
(one ``all_reduce`` over the flattened gradient) before AdamW steps, so
the parameters stay equal on every rank. The loss returned is the global
batch mean.
"""

from __future__ import annotations

import torch

from exaspim_tpu_torch.data.loader import counts_f32
from exaspim_tpu_torch.parallel._comm import (
    all_reduce_sum_,
    broadcast_,
    mesh_group,
)
from exaspim_tpu_torch.train.state import _update

__all__ = ["make_dp_train_step", "shard_batch", "replicate_params"]


def shard_batch(mesh, batch, axis="data"):
    """This rank's contiguous dim-0 share of each array of the global
    ``batch`` (a tuple of numpy arrays or tensors, sliced, not copied).
    The batch size must divide by the mesh size."""
    group, n, rank, _ = mesh_group(mesh, axis)

    def take(a):
        b = a.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide over {n} ranks")
        k = b // n
        return a[rank * k:(rank + 1) * k]

    return tuple(take(a) for a in batch)


def replicate_params(mesh, model, axis="data"):
    """Broadcast ``model``'s parameters and buffers from the mesh's rank 0,
    so every rank starts from the same weights."""
    group = mesh_group(mesh, axis)[0]
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            broadcast_(t.data, 0, group)
    return model


def make_dp_train_step(mesh, fg_weight=20.0, eps=1e-3, axis="data",
                       transform=None):
    """The data-parallel step ``(state, x, y, fg) -> (state, loss)`` on
    this rank's share of the global batch.

    Same math as :func:`exaspim_tpu_torch.train.state.make_train_step`
    (with a ``transform``, count batches are mapped on the device): the
    loss is the share's mean; the gradients are summed over the mesh in
    one flat ``all_reduce`` (with the loss) and divided by its size, which
    is the gradient of the global batch mean when the shares are equal;
    AdamW then steps every rank identically. The returned loss is the
    global mean.
    """
    group, n, _, _ = mesh_group(mesh, axis)

    def mean_over_mesh(model, loss):
        params = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        flat = all_reduce_sum_(flat, group) / n
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        return flat[-1]

    def step(state, x, y, fg):
        if transform is not None:
            x = transform.forward(counts_f32(x))
            y = transform.forward(counts_f32(y))
        return _update(state, x, y, fg, fg_weight, eps, mean_over_mesh)

    return step
