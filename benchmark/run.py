"""Run one cell of the benchmark of ``exaspim_tpu_torch`` on the GPU and
print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process a card, one cell, one run: set-up (imports, CUDA, the
kernels' build or load, inputs and weights from the seed, warm-up of the
cell's shapes), one measured window of ``--seconds``, then the check of
the window's outputs against the plain reference. ``--trace 1`` profiles
the window and prints the per-layer metrics instead of the end-to-end
ones. A cell on several cards starts one process a card (``launch.py``);
rank 0 prints the result. Exits non-zero, printing no result, without as
many CUDA devices as the cell asks for.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by the launcher on each rank of a cell on several cards.
    p.add_argument("--rank-child", action="store_true", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    # Caches of compilers that the program or torch may use stay inside
    # the checkout, at fixed paths; the kernels build into the package's
    # own build directory.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1 and not args.rank_child:
        import io

        from benchmark import launch

        # The ranks' set-up counts from this process's start (the
        # perf_counter clock is the host's monotonic clock, one for all).
        os.environ["BENCHMARK_T0"] = repr(T_PROCESS)
        held = io.StringIO()
        code = launch.launch([sys.executable, os.path.abspath(__file__),
                              *argv, "--rank-child"], chips, out=held)
        harness.refuse_forbidden()
        sys.stdout.write(held.getvalue())
        return code
    t_process, ranks = T_PROCESS, None
    if args.rank_child:
        # This rank's card first, before anything touches CUDA.
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        t_process = float(os.environ["BENCHMARK_T0"])
        ranks = harness.Ranks.from_env()
    harness.run_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace), device="cuda", t_process=t_process,
                     ranks=ranks)
    harness.end_ranks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
