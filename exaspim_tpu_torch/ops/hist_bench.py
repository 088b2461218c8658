"""Time the byte-histogram kernel and the entropy proxy on the card.

The data are the bench block's: ``neurite_phantom((256,) * 3, n_tubes=24,
seed=0)`` and its ``noisy_observation(seed=1)``. Two workloads:

* a validation batch: 32 of the noisy block's 64³ chunks, as int32
  counts, which the byte planes turn into 64 rows of 262,144 bytes;
* the 256³ pair: the noisy block and, standing in for a denoised output,
  the clean phantom, (2, 256, 256, 256) int32, 256 rows (2 volumes × 64
  chunks × 2 planes).

On each it measures ``byte_histogram`` on the rows, ``chunk_byte_histograms``
on the volumes (where the package has it) and ``cratio_proxy_batch`` on the
volumes, each two ways: ``graph_ms``, the device time of one call (CUDA
events around one replay of a CUDA graph of ``--reps`` calls, after one
warm-up replay, so the host's time per call does not enter), and
``wrapper_ms``, ``--reps`` back-to-back calls between CUDA events (the
host's time per call where it exceeds the device's). Beside them: the
plain version's time, one ``torch.bincount`` over the rows offset by
256 · row (a yardstick the port never calls) and the bound, the bytes read
once and the counts written once at 3.35 TB/s. Every kernel result is
held equal to its plain version.

It uses only what the proxy module has long had (``byte_histogram``,
``cratio_proxy_batch``, ``_chunks``, ``_byte_planes``), so the same file
times an older checkout put first on ``PYTHONPATH``:

    python -m exaspim_tpu_torch.ops.hist_bench [--reps 50]
    PYTHONPATH=OLD_ROOT python exaspim_tpu_torch/ops/hist_bench.py

With ``device="cpu"`` (the tests, at a small ``--block``) it runs the plain
versions on the host clock; those are no device numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from exaspim_tpu_torch.compression import proxy as P

__all__ = ["main", "PEAK_BYTES"]

PEAK_BYTES = 3.35e12  # H100 SXM
CHUNK, VAL_BATCH = 64, 32


def _capture_stream():
    """A side stream of the current device to capture on. torch's default
    capture stream is made once per process, on the device current at the
    first capture; captured on a later device, the wrappers launch on that
    device's own stream outside the capture and the capture fails."""
    return torch.cuda.Stream()


def _timers(device, reps):
    """``(graph_ms, wrapper_ms)`` of a call ``fn``; on the CPU both are
    host-clock means."""

    def host(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    if device != "cuda":
        return host, host

    def events(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=_capture_stream()):
            for _ in range(reps):
                fn()
        graph.replay()
        ms = events(graph.replay)
        del graph
        return ms

    def wrapper_ms(fn):
        fn()
        torch.cuda.synchronize()
        return events(lambda: [fn() for _ in range(reps)])

    return graph_ms, wrapper_ms


def _volumes(block, device):
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )

    clean, _ = neurite_phantom((block,) * 3, n_tubes=24, seed=0)
    noisy = noisy_observation(clean, seed=1)
    pair = torch.from_numpy(np.stack([noisy, np.rint(clean)]).astype(
        np.int32)).to(device)
    chunk = min(CHUNK, block)
    val = P._chunks(pair[:1], chunk)[0, :VAL_BATCH].contiguous()
    return val, pair, chunk


def _rows(vols, chunk):
    ch = P._chunks(vols, chunk)
    lo, hi = P._byte_planes(ch)
    return torch.stack([lo, hi], dim=2).reshape(-1, lo[0, 0].numel())


_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty"}


def device_ops(fn):
    """The device operations one call of ``fn`` enqueues, ``[(type, kernel
    name or None)]``: the call is captured in a CUDA graph (after a warm-up
    call) and the graph's nodes are read through ``libcuda``'s graph
    calls, so a memset, a copy or a second kernel cannot hide."""
    import ctypes

    drv = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=_capture_stream()):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(drv.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    ops = []
    for node in nodes:
        kind = ctypes.c_int()
        ok(drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        name = None
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction first, the CUkernel
            # at byte 56 (set instead where the runtime launched a kernel
            # handle); room to spare.
            params = (ctypes.c_void_p * 16)()
            ok(drv.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
               "cuGraphKernelNodeGetParams")
            cname = ctypes.c_char_p()
            if params[0]:
                ok(drv.cuFuncGetName(ctypes.byref(cname),
                                     ctypes.c_void_p(params[0])),
                   "cuFuncGetName")
            else:
                ok(drv.cuKernelGetName(ctypes.byref(cname),
                                       ctypes.c_void_p(params[7])),
                   "cuKernelGetName")
            name = cname.value.decode()
        ops.append((_NODE_TYPES.get(kind.value, str(kind.value)), name))
    del graph
    return ops


def edge_cases(device="cuda", seed=11):
    """The kernel's edge cases, each ``name -> (rows, vols, chunk)``: rows
    for ``byte_histogram``, ``(B, Z, Y, X)`` int32 volumes for
    ``chunk_byte_histograms``. Skew: one repeated byte; uniform bytes;
    the hi and lo planes of a noisy phantom (the proxy's real data), and
    counts that step between 0 and 65535 (every z-delta wraps). Shapes: row
    lengths no multiple of 16 and extents no multiple of the chunk or of 4;
    a 27³ chunk (the chunk shrunk to a small volume, 19,683 bytes a row);
    more rows than 65,535; base pointers off 16-byte alignment (a view one
    element into its storage)."""
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    clean, _ = neurite_phantom((64,) * 3, n_tubes=6, seed=seed)
    phantom = np.stack([noisy_observation(clean, seed=seed + 1),
                        np.rint(clean)]).astype(np.int32)
    wrap = np.zeros((1, 32, 16, 24), np.int32)
    wrap[:, 1::2] = 65535
    wrap[:, :, ::3] = rng.integers(65500, 65536, (1, 32, 6, 24))
    odd = rng.integers(0, 40, (1, 45, 38, 41), dtype=np.int32) + 1000
    c27 = phantom[:1, :27, 5:32, 9:36]
    buf_u8 = t(rng.integers(0, 256, 1 + 6 * 4099, dtype=np.uint8))
    buf_i32 = t(rng.integers(0, 65536, 1 + 2 * 32 * 36 * 40, dtype=np.int32))
    cases = {
        "one repeated byte": (t(np.full((3, 5000), 7, np.uint8)),
                              t(np.full((2, 32, 32, 32), 1234, np.int32)),
                              16),
        "uniform bytes": (t(rng.integers(0, 256, (4, 65536), dtype=np.uint8)),
                          t(rng.integers(0, 65536, (2, 64, 64, 64),
                                         dtype=np.int32)), 64),
        "noisy phantom planes": (None, t(phantom), 32),
        "wrap at 0 and 65535": (None, t(wrap), 8),
        "lengths no multiple of 16": (
            t(rng.integers(0, 256, (7, 262151), dtype=np.uint8)), t(odd), 16),
        "27^3 chunk": (None, t(c27), 64),
        "more rows than 65535": (
            t(rng.integers(0, 256, (70001, 40), dtype=np.uint8)),
            t(rng.integers(0, 300, (1, 132, 128, 128), dtype=np.int32)), 4),
        "misaligned base": (buf_u8[1:].view(6, 4099),
                            buf_i32[1:].view(2, 32, 36, 40), 16),
    }
    return {name: (_rows(vols, chunk) if rows is None else rows, vols, chunk)
            for name, (rows, vols, chunk) in cases.items()}


def _bincount(rows):
    n = rows.shape[0]
    offs = (rows.to(torch.int64) + 256 * torch.arange(
        n, device=rows.device)[:, None]).reshape(-1)
    return lambda: torch.bincount(offs, minlength=256 * n)


def workload(name, vols, chunk, reps, device):
    """One workload's record (see the module docstring)."""
    graph_ms, wrapper_ms = _timers(device, reps)
    rows = _rows(vols, chunk)
    has_chunks = hasattr(P, "chunk_byte_histograms")
    rec = {"workload": name, "volumes": list(vols.shape),
           "rows": list(rows.shape), "chunk_entry": has_chunks}

    want = P.byte_histogram_plain(rows)
    if not torch.equal(P.byte_histogram(rows), want):
        raise AssertionError(f"{name}: byte_histogram differs from plain")
    hist_bytes = rows.numel() + 4 * want.numel()
    rec["byte_histogram"] = {
        "graph_ms": graph_ms(lambda: P.byte_histogram(rows)),
        "wrapper_ms": wrapper_ms(lambda: P.byte_histogram(rows)),
        "plain_ms": wrapper_ms(lambda: P.byte_histogram_plain(rows)),
        "library_ms": wrapper_ms(_bincount(rows)),
        "bound_ms": 1e3 * hist_bytes / PEAK_BYTES, "bound_by": "bytes"}
    vol_bytes = vols.numel() * 4 + 4 * want.numel()
    if has_chunks:
        got = P.chunk_byte_histograms(vols, chunk)
        if not torch.equal(got.reshape(-1, 256), want):
            raise AssertionError(
                f"{name}: chunk_byte_histograms differs from plain")
        rec["chunk_byte_histograms"] = {
            "graph_ms": graph_ms(lambda: P.chunk_byte_histograms(vols, chunk)),
            "wrapper_ms": wrapper_ms(
                lambda: P.chunk_byte_histograms(vols, chunk)),
            "plain_ms": wrapper_ms(
                lambda: P.chunk_byte_histograms_plain(vols, chunk)),
            "bound_ms": 1e3 * vol_bytes / PEAK_BYTES, "bound_by": "bytes"}
    rec["cratio_proxy_batch"] = {
        "graph_ms": graph_ms(lambda: P.cratio_proxy_batch(vols, chunk)),
        "wrapper_ms": wrapper_ms(lambda: P.cratio_proxy_batch(vols, chunk)),
        "bound_ms": 1e3 * vol_bytes / PEAK_BYTES}
    h = rec["byte_histogram"]
    line = (f"{name}: byte_histogram {rows.shape[0]} rows x {rows.shape[1]} "
            f"B: graph {h['graph_ms']:.4f} ms, wrapper {h['wrapper_ms']:.4f} "
            f"ms, plain {h['plain_ms']:.4f}, bincount {h['library_ms']:.4f}, "
            f"bound {h['bound_ms']:.4f}")
    if has_chunks:
        c = rec["chunk_byte_histograms"]
        line += (f"; chunk_byte_histograms graph {c['graph_ms']:.4f} ms, "
                 f"wrapper {c['wrapper_ms']:.4f}, plain {c['plain_ms']:.4f},"
                 f" bound {c['bound_ms']:.4f}")
    p = rec["cratio_proxy_batch"]
    line += (f"; cratio_proxy_batch graph {p['graph_ms']:.4f} ms, wrapper "
             f"{p['wrapper_ms']:.4f}")
    print(line, flush=True)
    return rec


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hist_bench times kernels on a CUDA card; none is "
                           "available")
    val, pair, chunk = _volumes(args.block, device)
    out = {"device": (torch.cuda.get_device_name(0) if device == "cuda"
                      else "cpu (plain versions, host clock)"),
           "workloads": [
               workload(f"validation batch ({val.shape[0]} x {chunk}^3)",
                        val, chunk, args.reps, device),
               workload(f"{args.block}^3 pair", pair, chunk, args.reps,
                        device)]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
