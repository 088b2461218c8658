"""One rank of a cell on several processes, for the tests: runs the cell
from a benchmark copy once a seed, each run's result line on rank 0's
standard output. Started by ``launch.launch`` (which sets the ranks'
environment)::

    python3 -m benchmark.tests.rank_child --bench-dir <copy>/benchmark \
        --workload <cell> --device cpu --seeds 1 2 [--control fp8] \
        [--fault no_exchange|die|jax]

``--fault no_exchange`` leaves out the data-parallel step's gradient
all-reduce (each rank steps on its own share's gradient over the world
size); ``--fault die`` ends rank 1 with SIGKILL at its second window unit;
``--fault jax`` puts a stand-in module ``jax`` into rank 1's
``sys.modules`` as its window closes.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def plant(fault, rank):
    from benchmark import harness

    if fault == "no_exchange":
        from exaspim_tpu_torch.parallel import data_parallel

        data_parallel.all_reduce_sum_ = lambda t, group: t
    elif fault == "jax" and rank == 1:
        # A stand-in for JAX, loaded on rank 1 as its window closes.
        end = harness.Window.end_window

        def end_window(self):
            end(self)
            sys.modules["jax"] = types.ModuleType("jax")

        harness.Window.end_window = end_window
    elif fault == "die" and rank == 1:
        done = harness.Window.unit_done

        def unit_done(self, size):
            done(self, size)
            if len(self.units) == 2:
                os.kill(os.getpid(), signal.SIGKILL)

        harness.Window.unit_done = unit_done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bench-dir", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None, choices=("no_exchange", "die", "jax"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    ranks = harness.Ranks.from_env()
    plant(args.fault, ranks.rank)
    for seed in args.seeds:
        torch.manual_seed(0)
        harness.run_cell(args.workload, seed, args.seconds, False,
                         device=args.device, bench_dir=args.bench_dir,
                         t_process=time.perf_counter(), control=args.control,
                         ranks=ranks)
    harness.end_ranks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
