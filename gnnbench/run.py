"""Runs one cell of the benchmark once and prints its result as the last line
of standard output.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's graph and initial weights from ``--seed`` on the
card, builds the model from the port's public API, and drives the training
step through its first steps (kept for the correctness check) and a warm-up.
The window then runs the step back to back for ``--seconds`` with no host
synchronization, one CUDA event after each step. ``--trace 1`` then profiles
a span of steps with the harness's spans around its calls, and times the
host's dispatch of single steps. After that the program's state is freed and
the plain reference trains the same first steps; ``correct`` says whether
every number compared is within the cell's limit.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``BENCHMARK.json`` lists both). The
numbers compared, each beside its limit, come last in the line and as the
last lines of standard error. Without a CUDA device, or with fewer than the
cell asks for, the run exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE_DIR = CHECKOUT / ".gnnbench_cache"
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from gnnbench.harness import registry  # noqa: E402

FIRST_STEPS = 3            # the steps the reference follows
WARMUP_STEPS = 2           # further untimed steps before the window
HOST_STEPS = 20            # single steps timed on an idle queue (--trace 1)
TRACE_SECONDS = 0.5        # the traced span's length, as 10 to 50 steps
THREADS = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "tf_geometric_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_caches():
    """Every build and kernel cache at a fixed path inside the checkout;
    Python's bytecode too (written there even where the environment turns
    bytecode writing off), so that a run does not compile torch's sources
    again where the installation keeps no bytecode of its own. Called
    before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    sys.pycache_prefix = str(CACHE_DIR / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules():
    """Top-level names of loaded modules that the port's run must not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _synchronizer(device):
    import torch
    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)


def run_window(step, seconds: float, device):
    """Steps back to back until ``seconds`` have passed on the host clock,
    then one synchronization. Returns the host clock's start and end, the
    losses (on the device) and the per-step times in ms."""
    import torch
    cuda = device.type == "cuda"
    losses, marks = [], []
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    t0 = time.perf_counter()
    if not cuda:
        marks.append(t0)
    while True:
        losses.append(step()[0])
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    _synchronizer(device)()
    t1 = time.perf_counter()
    pairs = zip(marks, marks[1:])
    times = ([a.elapsed_time(b) for a, b in pairs] if cuda
             else [(b - a) * 1e3 for a, b in pairs])
    return t0, t1, losses, times


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             root=registry.BENCH_DIR, t_start: float = T_START, log=sys.stderr):
    """One run of a cell: returns the result line (a dict), the numbers
    compared last in it under ``checks``."""
    import torch

    from gnnbench.harness import check, counts, profile, training
    from gnnbench.harness.record import Record

    bench = registry.load_benchmark(root)
    cell = registry.load_json("workloads", cell_name, root)
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(THREADS)
    sync = _synchronizer(device)

    # --- set-up
    marks = [("start", t_start), ("imports", time.perf_counter())]
    data = training.make_data(cell, seed, device, root)
    graph, cfg = data["graph"], data["cfg"]
    sync()
    marks.append(("data", time.perf_counter()))
    trainer = training.Trainer(data, root)
    sync()
    marks.append(("model", time.perf_counter()))
    first = trainer.first_steps(FIRST_STEPS)
    sync()
    marks.append(("first_steps", time.perf_counter()))
    for _ in range(WARMUP_STEPS):
        trainer.step()
    sync()
    marks.append(("warmup", time.perf_counter()))
    print("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
          file=log)

    # --- the window; what set-up left is moved out of the collector's view, so
    # that no collection of the window walks it again
    gc.collect()
    gc.freeze()
    t0, t1, losses, step_times = run_window(trainer.step, seconds, device)
    gc.unfreeze()
    rec = Record(root)
    rec.cfg, rec.setup_s, rec.window_s = cfg, t0 - t_start, t1 - t0
    rec.steps, rec.step_times_ms = len(losses), step_times
    rec.num_features, rec.num_classes = graph["x"].shape[1], graph["num_classes"]
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    print(f"window: {rec.steps} steps in {rec.window_s:.3f} s, set-up {rec.setup_s:.3f} s",
          file=log)

    if trace:
        mean_step = rec.window_s / rec.steps
        steps = min(50, max(10, round(TRACE_SECONDS / mean_step)))
        rec.profile = profile.profile_steps(trainer.step, steps, sync)
        for _ in range(HOST_STEPS):
            sync()
            t = time.perf_counter()
            trainer.step()
            rec.host_enqueue_ms.append((time.perf_counter() - t) * 1e3)
        sync()

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}

    # --- the program's state is freed; then the reference
    del trainer, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        rec.stats = counts.graph_stats(graph["edge_index"], graph["num_nodes"])
    t_ref = time.perf_counter()
    ref_module = registry.load_module("reference", cfg["model"], root)
    ref = check.reference_run(ref_module, cfg, graph, data["weights"], first["masks"])
    numbers = check.compare(first, ref)
    correct, table = check.judge(numbers, cell["limits"])
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=log)

    metrics = {}
    for m in registry.cell_metrics(bench, cell_name, trace):
        value = rec.read(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct and failed == 0), "attempted": rec.steps,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace and rec.profile is not None and rec.profile.ops:
        dev_info["busy_s"], dev_info["window_s"] = rec.profile.busy_s, rec.profile.window_s
        result["breakdown"] = {"device_ops": rec.profile.top_ops(),
                               "idle_gaps": rec.profile.idle_gaps()}
    result["checks"] = table
    return result


def main(argv=None, root=registry.BENCH_DIR, device=None, t_start: float = T_START) -> int:
    """The command line. ``device`` other than None skips the look for a card
    (the CPU tests drive a run so)."""
    args = parse_args(argv)
    bench = registry.load_benchmark(root)
    entry = registry.cell_entry(bench, args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device(device), root, t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        value = row["value"]
        shown = "none" if value is None or (isinstance(value, float) and math.isnan(value)) \
            else repr(value)
        print(f"check {name} {shown} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    pin_caches()
    sys.exit(main())
