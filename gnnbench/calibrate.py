"""Readings that the correctness limits are set from, at a cell's own size.

    python3 gnnbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 3,4,5] [--fault-seeds 6,7,8] [--faults a,b] [--out FILE]

For each of ``--seeds``: the program's first steps, as a run's set-up drives
them, against the plain reference (the lower readings). For each of
``--control-seeds``: the control, the reference computed one precision lower
than the configuration states, in the program's place (the upper readings).
For each of ``--fault-seeds``: the program with each fault of
``harness/faults.py`` (or of ``--faults``) planted. One JSON line per reading, on standard output
and appended to ``--out``. The benchmark's runs do not run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from gnnbench.harness import check, registry, training  # noqa: E402
from gnnbench.harness.faults import FAULTS, planted  # noqa: E402
from gnnbench.run import FIRST_STEPS  # noqa: E402


def _program_numbers(cell, seed, device, root, fault=None):
    import torch
    data = training.make_data(cell, seed, device, root)
    t = time.perf_counter()
    if fault is None:
        first = training.Trainer(data, root).first_steps(FIRST_STEPS)
    else:
        with planted(fault):
            first = training.Trainer(data, root).first_steps(FIRST_STEPS)
    build_s = time.perf_counter() - t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_module = registry.load_module("reference", data["cfg"]["model"], root)
    ref = check.reference_run(ref_module, data["cfg"], data["graph"], data["weights"],
                              first["masks"])
    return check.compare(first, ref), build_s, check.leaf_gaps(first, ref), _step_gaps(first, ref)


def _step_gaps(prog, ref):
    """Each step's relative loss gap (``loss_gap`` is the largest)."""
    return [abs(float(a) - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]


def _control_numbers(cell, seed, device, root):
    data = training.make_data(cell, seed, device, root)
    ref_module = registry.load_module("reference", data["cfg"]["model"], root)
    masks = [training.draw_masks(data["dropouts"], data["generator"], device)
             for _ in range(FIRST_STEPS)]
    args = (ref_module, data["cfg"], data["graph"], data["weights"], masks)
    ref = check.reference_run(*args)
    ctl = check.reference_run(*args, control=True)
    return check.compare(ctl, ref), check.leaf_gaps(ctl, ref), _step_gaps(ctl, ref)


def main(argv=None, root=registry.BENCH_DIR, device=None):
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state TF32 off
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.load_json("workloads", args.workload, root)

    def seeds(s):
        return [int(v) for v in s.split(",") if v]

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **numbers,
                           **extra})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds(args.seeds):
        numbers, build_s, leaves, steps = _program_numbers(cell, seed, device, root)
        emit("program", seed, numbers, first_steps_s=build_s, step_loss_gaps=steps, leaves=leaves)
    for seed in seeds(args.control_seeds):
        numbers, leaves, steps = _control_numbers(cell, seed, device, root)
        emit("control", seed, numbers, step_loss_gaps=steps, leaves=leaves)
    for seed in seeds(args.fault_seeds):
        for fault in args.faults.split(","):
            emit(fault, seed, _program_numbers(cell, seed, device, root, fault)[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
