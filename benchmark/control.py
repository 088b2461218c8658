"""Readings from which a cell's limits are set: in one process, runs of
the program on several seeds, and runs on others with the control (the
plain reference in the precision below the configuration's) or a planted
fault in the program's place, each a short window at the cell's own size,
printing each run's result line. The benchmark's own runs never run the
control.

    python3 benchmark/control.py --workload <cell> --seconds 8 \
        --seeds 11 12 13 --control-seeds 21 22 23

Needs a CUDA device, and one a rank for a cell on several cards, which
runs in one process a card (``launch.py``; rank 0 prints).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", default=None,
                   choices=("fp8", "tf32_e4m3", "half_batch", "bf16"),
                   help="what takes the program's place: the reference in "
                        "float8, the precision below the configuration's "
                        "bf16 (the control of the U-Net cells), in TF32 "
                        "and an e4m3 distance table, the ones below float32 "
                        "and the bf16 table (the control of the BM4D cell), "
                        "with half of each batch left "
                        "out (a fault, training cells), or in bf16 itself "
                        "(a witness of what the configuration's precision "
                        "alone reads); by default the cell's own control")
    p.add_argument("--rank-child", action="store_true", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _, traffic, _ = harness.cell_files(HERE, bench, args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    if chips > 1 and not args.rank_child:
        from benchmark import launch

        return launch.launch([sys.executable, os.path.abspath(__file__),
                              *argv, "--rank-child"], chips,
                             timeout_s=3600.0)
    ranks = None
    if args.rank_child:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        ranks = harness.Ranks.from_env()
    if ranks is None or ranks.rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"# {smi.strip()}", flush=True)
    control = args.control
    if control is None:
        control = harness.entry_module(HERE, traffic).CONTROL
    runs = [(s, None) for s in args.seeds] + [
        (s, control) for s in args.control_seeds]
    for seed, control in runs:
        if ranks is None or ranks.rank == 0:
            print(f"# seed {seed} control {control}", flush=True)
        harness.run_cell(args.workload, seed, args.seconds, False,
                         device="cuda", t_process=time.perf_counter(),
                         control=control, ranks=ranks)
    harness.end_ranks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
