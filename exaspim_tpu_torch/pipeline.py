"""Whole-volume streaming denoise pipeline.

Counterpart of ``exaspim_tpu/pipeline.py``. Whole-brain volumes are far
larger than host or device memory; this module streams a chunked volume
through the card in halo'd super-tiles (full-plane z-slabs by default; y/x
tiled too when ``max_block_voxels`` bounds the device block):

    reader thread (tensorstore chunk fetch into a pool of host staging
    buffers, page-locked on the card; host memory only)
        → bounded prefetch queue
        → tiled inference on the device (main thread: every CUDA call):
          each tile goes up as uint16, and only its uint16 core comes back
        → the core copied into the output, or an asynchronous Zarr v3
          write, awaited at the end

Each tile carries a ``patch_size`` halo on interior faces and its low edge
is aligned to the global stride grid, so the tile-local patch grid is the
single-pass grid wherever it can touch the core: seams are exact (the same
argument as :func:`exaspim_tpu_torch.inference._predict_streaming`).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from exaspim_tpu_torch.inference import (
    _MAX_DEVICE_VOXELS,
    _predict,
    plan_stream_cores,
    plan_tiling,
)
from exaspim_tpu_torch.parallel.multihost import is_primary
from exaspim_tpu_torch.utils import img_io
from exaspim_tpu_torch.utils.profiling import span

__all__ = ["denoise_volume"]


def _predict_on_mesh(block, model, transform, mesh, patch_size, overlap,
                     trim, batch_size):
    """:func:`predict_sharded` of one super-tile: a z extent that does not
    split into one ``patch_size`` core per rank is edge-padded up to the
    larger of ``n · patch_size`` and the next multiple of ``n``, and the
    result cropped back (JAX ``pipeline.py:171-186``)."""
    from exaspim_tpu_torch.parallel.spatial import predict_sharded

    n = mesh.size()
    zb = block.shape[0]
    pad = max(n * patch_size, zb + (-zb) % n) - zb
    if pad:
        block = np.pad(block, [(0, pad), (0, 0), (0, 0)], mode="edge")
    return predict_sharded(block, model, transform, mesh,
                           patch_size=patch_size, overlap=overlap, trim=trim,
                           batch_size=batch_size)[:zb]


def _tile_plan(shape, cores, halo, stride):
    """3-axis super-tile plan: per tile, ``(d0, d1, lo, hi)`` per axis.

    ``(d0, d1)`` is the core (written) range, ``(lo, hi)`` the halo'd
    fetch range with the low edge aligned to the global stride grid.
    """
    plan = []
    for z0 in range(0, shape[0], cores[0]):
        for y0 in range(0, shape[1], cores[1]):
            for x0 in range(0, shape[2], cores[2]):
                tile = []
                for d0, core, dim in zip((z0, y0, x0), cores, shape):
                    d1 = min(d0 + core, dim)
                    lo = max(d0 - halo, 0)
                    lo -= lo % stride  # align with the global grid
                    hi = min(d1 + halo, dim)
                    tile.append((d0, d1, lo, hi))
                plan.append(tuple(tile))
    return plan


def _staging_pool(plan, n, device):
    """``n`` host int16 buffers the size of the plan's largest tile
    (page-locked on the card), each with its uint16 view; none where that
    tile is above the device block limit, since such a tile streams through
    super-tiles that stage their own sub-blocks."""
    largest = max(int(np.prod([hi - lo for _, _, lo, hi in tile]))
                  for tile in plan)
    if largest > _MAX_DEVICE_VOXELS:
        return []
    pinned = torch.device(device).type == "cuda"
    bufs = [torch.empty(largest, dtype=torch.int16, pin_memory=pinned)
            for _ in range(n)]
    return [(buf, buf.numpy().view(np.uint16)) for buf in bufs]


def denoise_volume(img, model, transform, output_path=None, slab_z=256,
                   patch_size=64, overlap=12, trim=5, batch_size=32,
                   clevel=5, chunks=(1, 1, 64, 64, 64), prefetch=2,
                   progress=False, mesh=None, max_block_voxels=None,
                   device="cuda"):
    """Denoise an arbitrarily large volume super-tile by super-tile.

    ``img``: the path of a chunked local volume (opened lazily) or an
    ndarray. With ``output_path`` the result streams into a Zarr v3 array
    and the path is returned; otherwise the assembled uint16 volume is
    returned (it must fit host memory). ``model`` lives on ``device``.

    Tiling: full-plane z-slabs of height ``slab_z`` by default (sequential
    chunk order for typical Zarr layouts). When ``max_block_voxels`` is
    set, y/x are super-tiled too
    (:func:`exaspim_tpu_torch.inference.plan_stream_cores`), so volumes
    whose single plane times the slab height exceeds device memory still
    stream. Seams are exact either way.

    With a 1-D ``mesh`` (:func:`~exaspim_tpu_torch.parallel.make_mesh`)
    every rank calls this with the same arguments and each super-tile is
    z-sharded over the ranks
    (:func:`~exaspim_tpu_torch.parallel.predict_sharded`); a tile whose z
    extent does not split into one ``patch_size`` core per rank is
    edge-padded first and cropped after, as in the JAX package. Every rank
    returns the assembled volume; only the primary rank writes
    ``output_path``.
    """
    with span("pipeline.volume"):
        src = img_io.read(img) if isinstance(img, str) else img
        shape = tuple(int(d) for d in src.shape[-3:])
        Z, Y, X = shape
        if patch_size == "auto":
            # Plan on the slab geometry (z capped at the slab height); the
            # same patch is used for every slab, so the global stride grid,
            # and with it seam exactness, is preserved.
            patch_size, batch_size = plan_tiling(
                (min(Z, int(slab_z)), Y, X), overlap
            )
        halo = patch_size
        slab_z = max(int(slab_z), patch_size)
        if max_block_voxels is not None:
            cores = plan_stream_cores(
                shape, patch_size, overlap, int(max_block_voxels)
            )
            cores = (min(cores[0], slab_z), cores[1], cores[2])
        else:
            cores = (slab_z, Y, X)
        plan = _tile_plan(shape, cores, halo, patch_size - overlap)

        primary = mesh is None or is_primary()
        out_arr = None
        out_store = None
        if output_path is None:
            out_arr = np.empty(shape, np.uint16)
        elif primary:
            import tensorstore as ts

            spec = {
                "driver": "zarr3",
                "kvstore": img_io._kvstore(output_path),
                "metadata": {
                    "shape": [1, 1, *shape],
                    "chunk_grid": {
                        "name": "regular",
                        "configuration": {"chunk_shape": list(chunks)},
                    },
                    "data_type": "uint16",
                    "codecs": img_io._zarr3_codecs("zstd", clevel, "shuffle",
                                                   2),
                },
                "create": True,
                "delete_existing": True,
            }
            out_store = ts.open(spec).result()

        lazy = hasattr(src, "read")
        ndim = len(src.shape)

        def fetch(tile, into=None):
            """The tile's block as uint16: copied into the front of the
            staging array ``into`` where given."""
            sl = tuple(slice(lo, hi) for _, _, lo, hi in tile)
            idx = (Ellipsis,) + sl if ndim == 5 else sl
            block = np.asarray(src[idx].read().result() if lazy else src[idx])
            if block.ndim == 5:
                block = block[0, 0]
            if into is None:
                return block.astype(np.uint16)
            staged = into[:block.size].reshape(block.shape)
            np.copyto(staged, block, casting="unsafe")
            return staged

        # Reader thread: keeps `prefetch` super-tiles in flight. It touches
        # host memory only; an exception is handed to the caller's thread.
        # When the caller's loop ends early (an exception in `predict`),
        # `stop` lets the reader drop its fetched tile and leave instead of
        # blocking on the full queue for good. The spans below are the main
        # thread's: the reader's own time shows as `pipeline.wait`.
        # Off the mesh, and where no tile streams, it fetches into
        # `prefetch + 2` staging buffers made here, each the size of the
        # largest tile, which the main thread hands back once the tile's
        # core has come down (so its upload has completed): one in the
        # reader's hands, `prefetch` queued, one in use. torch's host
        # allocator keeps page-locked blocks for reuse, so after the first
        # volume of a size no call allocates any.
        q = queue.Queue(maxsize=max(1, prefetch))
        _STOP = object()
        stop = threading.Event()
        free = queue.Queue()
        pool = [] if mesh is not None else _staging_pool(
            plan, max(1, prefetch) + 2, device)
        for buf in pool:
            free.put(buf)

        def hand_over(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def take_free():
            while not stop.is_set():
                try:
                    return free.get(timeout=0.1)
                except queue.Empty:
                    pass
            return None

        def reader():
            try:
                for tile in plan:
                    buf = None
                    if pool:
                        buf = take_free()
                        if buf is None:
                            return
                    into = None if buf is None else buf[1]
                    item = (tile, fetch(tile, into), buf)
                    if not hand_over(item):
                        return
                    del item, buf
                hand_over(_STOP)
            except BaseException as exc:
                hand_over(exc)

        reader_thread = threading.Thread(target=reader, daemon=True,
                                         name="denoise_volume-reader")
        reader_thread.start()

        pending_writes = []
        done = 0
        try:
            while True:
                with span("pipeline.wait"):
                    item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                tile, block, buf = item
                del item
                (z0, z1, lo, _), (y0, y1, loy, _), (x0, x1, lox, _) = tile
                crop = (slice(z0 - lo, z0 - lo + (z1 - z0)),
                        slice(y0 - loy, y0 - loy + (y1 - y0)),
                        slice(x0 - lox, x0 - lox + (x1 - x0)))
                with span("pipeline.slab"):
                    if mesh is not None:
                        core = _predict_on_mesh(block, model, transform, mesh,
                                                patch_size, overlap, trim,
                                                batch_size)[crop]
                    else:
                        core = _predict(
                            block, model, transform, patch_size=patch_size,
                            overlap=overlap, trim=trim, batch_size=batch_size,
                            max_device_voxels=_MAX_DEVICE_VOXELS,
                            device=device, crop=crop,
                            staged=None if buf is None else buf[0],
                        )
                with span("pipeline.write"):
                    if out_arr is not None:
                        out_arr[z0:z1, y0:y1, x0:x1] = core
                    elif primary:
                        # The write holds `core` until it has copied it, and
                        # no later tile reuses the staging block under it.
                        pending_writes.append(
                            out_store[0, 0, z0:z1, y0:y1, x0:x1].write(core)
                        )
                # Drop the core's staging block before the next tile asks
                # for one, and hand the tile's buffer back to the reader.
                del block, core
                if buf is not None:
                    free.put(buf)
                done += 1
                if progress:
                    print(f"denoise_volume: tile {done}/{len(plan)}",
                          flush=True)
        finally:
            stop.set()
        # The reader has handed over its end; once it has left, the staging
        # buffers go back to the allocator when this call returns.
        reader_thread.join()

        with span("pipeline.drain"):
            for w in pending_writes:
                w.result()
        return out_arr if out_arr is not None else output_path
