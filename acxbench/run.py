"""Run one cell of the benchmark of ``mpi_acx_torch`` and print its result.

    python3 acxbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit); the last lines of standard
error repeat the checks. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (``BENCHMARK.json``).

Exit codes: 0 with a result; 2 bad arguments or files; 3 no CUDA device,
or fewer than the cell asks for; 4 JAX, Flax or the JAX package was
loaded; anything else a failure of the run.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (set before torch is imported); the port's own nvcc build directory
    is ``build/torch_kernels`` there already."""
    cache = CHECKOUT / "build" / "acxbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # One process with few threads: the host runs the serve loop.
    os.environ["OMP_NUM_THREADS"] = "1"


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (res.stdout.strip().splitlines() or ["nvidia-smi: no reading"])[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")
    seed = args.seed & ((1 << 63) - 1)

    _fixed_caches()
    sys.path.insert(0, str(CHECKOUT))
    from acxbench import harness
    try:
        bench = harness.Bench()
        chips = bench.workload(args.workload)["chips"]
    except (FileNotFoundError, KeyError, json.JSONDecodeError) as exc:
        print(f"acxbench: {exc}", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"acxbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    print(f"card: {_card()} (shares are of the H100 SXM's published peaks "
          f"at 700 W)", flush=True)

    res = harness.run_cell(bench, args.workload, seed, args.seconds,
                           bool(args.trace), "cuda")
    setup_s = res["t_window"] - T_PROCESS

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"acxbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 4

    metrics = dict(res["metrics"])
    if not args.trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    tr = res["art"].trace if res["art"] is not None else None
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        order = ["k1", "k1_lse", "k2", "decode_step", "prefill",
                 "data_next", "step", "serve_call", "window"]
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_by_span(order, 10)}
    out["checks"] = res["checks"]
    if tr is not None:
        print("trace: {} of {} device operations tied to a launch ({} "
              "runtime calls)".format(*tr.linked), file=sys.stderr)
        for name in sorted(tr.spans):
            print(f"span {name}: {tr.count(name)} ranges, "
                  f"{int(tr.inside(name).sum())} device ops, "
                  f"{tr.device_s(name):.6f} device s", file=sys.stderr)
    print(f"setup_s {setup_s:.3f}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
