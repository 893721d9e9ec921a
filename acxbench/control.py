"""The control of a cell's correctness check, and its planted faults, on
the chip: the readings that its limits are set between.

    python3 acxbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 5] [--fault half_batch]

Serving cells: per seed, the program serves ``--seconds`` of the cell's
traffic; on the requests the check samples, the program's widest logit
gap is read beside the control's, the reference computed with every
product in float8 e4m3 (the precision below the configuration's
bfloat16): at each served position, the float32 reference's gap of the
token the float8 reference puts first.

Training cells: per seed, the program's three set-up steps and the
reference's are compared as a run compares them, and so is the float8
reference in the program's place (the control: float8 training's hybrid
recipe), and the float8 reference with e4m3 cotangents too
(``control_e4m3``). ``--fault half_batch`` runs the program on half of
each microbatch's rows instead.

One JSON line per seed on standard output. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from acxbench.run import _fixed_caches  # noqa: E402


def _half_batch(driver_cls):
    class HalfBatch(driver_cls):
        """The train step given half of each microbatch's rows: the mean
        is taken over the rest."""

        def _one_step(self):
            tokens, targets = next(self.feed)
            h = tokens.shape[1] // 2
            loss, self.params = self.step(self.params,
                                          tokens[:, :h].contiguous(),
                                          targets[:, :h].contiguous())
            return loss.item()
    return HalfBatch


def readings(bench, cell, seed, seconds, fault, device) -> dict:
    import torch
    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    run = SimpleNamespace(cell=cell, workload=wl, config=cfg, seed=seed,
                          device=device, trace=False,
                          family=bench.family(cfg["family"]))
    cls = bench.driver(wl["driver"]).Driver
    if fault == "half_batch":
        cls = _half_batch(cls)
    drv = cls(run)
    drv.setup()
    out = {"cell": cell, "seed": seed, "fault": fault}
    if drv.kind == "serve":
        drv.window(seconds)
        drv.release()
        out.update(drv.check(control=True))
        out["requests"] = len(drv.in_window())
    else:
        from acxbench.drivers.train import compare_train
        drv.release()
        ref = drv.reference_run("f32")
        out["program"] = compare_train((drv.losses, drv.grad1, drv.change),
                                       ref, drv.names)
        if fault is None:
            for key, prec in (("control", "fp8"),
                              ("control_e4m3", "fp8_e4m3")):
                out[key] = compare_train(drv.reference_run(prec), ref,
                                         drv.names)
    del drv
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    args = ap.parse_args(argv)
    _fixed_caches()
    from acxbench import harness
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.Bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(bench, args.workload, seed, args.seconds,
                                  args.fault, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
