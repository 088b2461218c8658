"""The collectives of the sharded paths, on either backend.

NCCL moves device tensors directly, card to card. Gloo moves host
tensors, so a CUDA tensor under gloo (processes that share a card, or a
host without NCCL) is staged through host memory and copied back; CPU
tensors move as they are.

Stream order under NCCL: each call enqueues its transfers on NCCL's own
stream, which first waits for the compute stream (the slab's planes are
written before they are sent), and waits for them before it returns, so
the compute stream reads a received halo only after it has arrived. The
group records every buffer on NCCL's stream, so the caching allocator
hands none of them out again while a transfer may still touch it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(t, group):
    return t.is_cuda and dist.get_backend(group) != "nccl"


def exchange_halos(slab, halo, group):
    """``(from_above, from_below)``: the last ``halo`` planes (dim 0) of
    the previous rank's slab and the first ``halo`` of the next rank's.
    A rank at the end of the group gets zeros there, as ``ppermute``
    gives. A middle rank sends and receives on both sides in one
    ``batch_isend_irecv``. Every rank of the group must call it (the
    first point-to-point call of an NCCL group is collective)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    staged = _staged(slab, group)

    def buf(t):
        t = t.contiguous()
        return t.cpu() if staged else t

    send_down, send_up = buf(slab[-halo:]), buf(slab[:halo])
    above, below = torch.zeros_like(send_down), torch.zeros_like(send_up)
    ops = []
    if r + 1 < n:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, send_down, peer, group),
                dist.P2POp(dist.irecv, below, peer, group)]
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, send_up, peer, group),
                dist.P2POp(dist.irecv, above, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return above.to(slab.device), below.to(slab.device)


def gather_z(core, group):
    """Every rank's ``core`` (equal shapes), concatenated along dim 0 in
    rank order, on every rank."""
    n = dist.get_world_size(group)
    t = core.contiguous()
    if _staged(t, group):
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).to(core.device)


def all_reduce_sum_(t, group):
    """In-place sum of ``t`` over the group."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t, src, group):
    """In-place broadcast of ``t`` from group rank ``src``."""
    peer = dist.get_global_rank(group, src)
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, peer, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, peer, group=group)
    return t


def mesh_group(mesh, axis=None):
    """``(group, world size, rank, device)`` of the mesh axis ``axis``
    (default: the one axis of a 1-D mesh): the device is the current CUDA
    device for a CUDA mesh, else the CPU."""
    if axis is None:
        (axis,) = mesh.mesh_dim_names
    elif axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, "
                         f"not {axis!r}")
    group = mesh.get_group(axis)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    return (group, dist.get_world_size(group), dist.get_rank(group),
            device)
