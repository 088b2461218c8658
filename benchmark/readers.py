"""What the per-layer readers share: which device operations are the
port's conv kernels (rows 1-3 of its kernel table) and its block matcher
(rows 4-5), by the kernel names the program gives them, and the
arithmetic that turns a trace and counters into shares."""

from __future__ import annotations

import os

from benchmark import trace as trace_mod
from benchmark import yardstick

# Rows 1-2 (csrc/nb_conv3d.cu, nb_conv3d_fwd.cuh) and row 3
# (csrc/nb_conv3d_dw.cu).
CONV_FWD = ("nb_conv3d_kernel", "nb_stats_reduce_kernel")
CONV_DW = ("dw_halo_kernel", "dw_zstack_kernel", "dw_flat_kernel",
           "dw_panel_kernel", "dw_reduce_kernel")
# Rows 4-5 (csrc/bm4d_match.cu with bm4d_select.cuh inside).
MATCH = ("bm4d_match_kernel", "bm4d_select_kernel")
# The conv kernels each of the program's sources holds, by the source's
# name in a traffic file's ``kernels``.
CONV_OF_SOURCE = {"nb_conv3d": CONV_FWD, "nb_conv3d_dw": CONV_DW}


def is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def has(name, frags):
    return any(f in name for f in frags)


def conv_kernels(run):
    """The conv kernels of the sources the cell builds."""
    return tuple(f for src in run.traffic["kernels"]
                 for f in CONV_OF_SOURCE.get(src, ()))


def conv_seconds(run, frags):
    return trace_mod.device_seconds(run.trace, lambda n: has(n, frags))


def other_seconds(run, frags):
    """Device seconds of the kernels outside ``frags`` (copies and
    memsets left out)."""
    return trace_mod.device_seconds(
        run.trace, lambda n: not is_copy(n) and not has(n, frags))


def counts_dir(run):
    """The counts files of the benchmark the run was read from."""
    return os.path.join(run.bench_dir, "counts")


def counted_model(run):
    """The cell's model configuration, or None where the benchmark has no
    counts file for its model (its readers then report nothing)."""
    mc = run.config["model_config"]
    if yardstick.counts_module(mc["model"], counts_dir(run)) is None:
        return None
    return mc


def forwards_per_launch(run):
    """3³ forward convs a model forward launches, or None for a model
    without counts."""
    mc = counted_model(run)
    if mc is None:
        return None
    return sum(1 for s in yardstick.conv_shapes(mc, 8,
                                                counts_dir=counts_dir(run))
               if s[0] == "fwd")


def share(bound_s, device_s):
    """A roofline share in %, or None where nothing ran."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s



def is_comm(name):
    """The collectives' kernels (NCCL's ``ncclDevKernel_AllReduce_...``)."""
    return "nccl" in name.lower()


def comm_intervals(run):
    """The traced rank's collective kernels and its compute kernels (the
    rest, copies and memsets left out), each as ``[(start_us, end_us)]``,
    or None where no collective ran on its device."""
    if run.trace is None:
        return None
    comm = [(a, b) for a, b, n in run.trace.device if is_comm(n)]
    if not comm:
        return None
    compute = [(a, b) for a, b, n in run.trace.device
               if not is_comm(n) and not is_copy(n)]
    return comm, compute
