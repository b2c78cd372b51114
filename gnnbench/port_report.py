"""Runs one cell's training step with the port's own tracer
(``tf_geometric_tpu_torch.utils.profiling``) and prints what it recorded as
one JSON line on standard output.

    python3 gnnbench/port_report.py --workload <cell> --seed <n>

Set-up is the benchmark run's (``run.py``: the cell's data, the model, its
first steps and warm-up), with the tracer on. Then ``BLOCKS`` blocks of
``STEPS`` single steps, each started on an idle queue, the tracer off and
on in turns (off, on, on, off, ...), and a profiled span of steps with the
tracer on. The line holds:

- ``setup_s`` (process start to the end of the warm-up), ``layout_build_s``
  (inside ``tfg.setup.norm_adj``, ``csr_layout``, ``gat_layout``),
  ``kernel_load_s`` (inside ``tfg.setup.kernel_load``; None where no kernel
  library was loaded, as on the CPU) and ``setup_counters`` (each counter's
  change over set-up: layout builds, hubs split, libraries built or found);
- ``ops_host_ms`` (host ms a step inside ``tfg.ops.*`` spans) and
  ``conv_host_ms`` (self ms of ``tfg.layers.*`` and ``tfg.nn.conv.*``: less
  the spans they hold), over the blocks with the tracer on;
  ``host_ms_off`` / ``host_ms_on`` (each block's mean host ms a step) and
  ``on_cost_ms`` (mean and standard error of on − off over the block pairs);
  ``counters_per_step`` (each counter's change a step, over every block);
- ``idle_gaps`` (the harness's labels) and ``idle_gaps_by_span`` (the
  innermost ``tfg.`` span open on the launching thread, else the harness's
  label) of the profiled span: each [label, seconds];
- ``span_us``: a bare call, a decorated call and an empty ``with span``
  with the tracer off, and an empty span with it on, in µs each.

It does not run the benchmark's window or its reference; the benchmark's
own lines (``run.py``) are not changed by it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from gnnbench import run  # noqa: E402
from gnnbench.harness import port_trace, registry  # noqa: E402

LAYOUT_SPANS = ("tfg.setup.norm_adj", "tfg.setup.csr_layout", "tfg.setup.gat_layout")
BLOCKS = 8                 # blocks of host steps, a multiple of 4 (off, on, on, off)
STEPS = run.HOST_STEPS     # single steps a block
MICRO_CALLS = 200_000      # calls a span's cost is timed over


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    return p.parse_args(argv)


def span_costs(calls: int) -> dict:
    """µs a call: a bare function, the same decorated by ``span`` with the
    tracer off, an empty ``with span`` off, and on."""
    from tf_geometric_tpu_torch.utils import profiling

    def bare():
        return None

    decorated = profiling.span("tfg.report.x")(bare)

    def timed(fn, n):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    def empty_span():
        with profiling.span("tfg.report.x"):
            pass

    res = {"bare_call": timed(bare, calls), "decorated_off": timed(decorated, calls),
           "with_off": timed(empty_span, calls)}
    with profiling.tracing():
        res["with_on"] = timed(empty_span, max(1, calls // 10))
    return res


def host_blocks(step, blocks: int, steps: int, synchronize):
    """``blocks`` blocks of ``steps`` single steps, each started on an idle
    queue, the tracer off and on in turns (off, on, on, off, ...). Returns
    each mode's block means (host ms a step), the spans of the on blocks and
    the median seconds a step of the off blocks, waits included."""
    import contextlib

    from tf_geometric_tpu_torch.utils import profiling
    means = {"off": [], "on": []}
    spans, walls = [], []
    for mode in ("off", "on", "on", "off") * (blocks // 4):
        first = len(profiling.spans())
        ms = []
        synchronize()
        t0 = time.perf_counter()
        with profiling.tracing() if mode == "on" else contextlib.nullcontext():
            for _ in range(steps):
                synchronize()
                t = time.perf_counter()
                step()
                ms.append((time.perf_counter() - t) * 1e3)
            synchronize()
        if mode == "off":
            walls.append((time.perf_counter() - t0) / steps)
        means[mode].append(statistics.mean(ms))
        spans.extend(port_trace.since(profiling.spans(), first))
    return means, spans, statistics.median(walls)


def report(cell_name: str, seed: int, device, root=registry.BENCH_DIR, t_start: float = T_START,
           log=sys.stderr) -> dict:
    import torch

    from gnnbench.harness import training
    from tf_geometric_tpu_torch.utils import profiling

    cell = registry.load_json("workloads", cell_name, root)
    torch.backends.cuda.matmul.allow_tf32 = False  # as run.py: the configurations state TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(run.THREADS)
    sync = run._synchronizer(device)

    first, before = len(profiling.spans()), profiling.counters()
    with profiling.tracing():
        data = training.make_data(cell, seed, device, root)
        trainer = training.Trainer(data, root)
        trainer.first_steps(run.FIRST_STEPS)
        for _ in range(run.WARMUP_STEPS):
            trainer.step()
        sync()
    setup_s = time.perf_counter() - t_start
    setup_spans = port_trace.since(profiling.spans(), first)
    setup_counters = port_trace.moved(before, profiling.counters())
    layout_ns = port_trace.outer_ns(setup_spans, LAYOUT_SPANS)
    load_ns = port_trace.outer_ns(setup_spans, ["tfg.setup.kernel_load"])
    print(f"set-up {setup_s:.3f} s", file=log)

    before = profiling.counters()
    means, spans, step_s = host_blocks(trainer.step, BLOCKS, STEPS, sync)
    counters_per_step = port_trace.per_step(before, profiling.counters(), BLOCKS * STEPS)
    on_steps = BLOCKS // 2 * STEPS
    ops_ns = port_trace.outer_ns(spans, ["tfg.ops."])
    conv_ns = port_trace.self_ns(spans, ["tfg.layers.", "tfg.nn.conv."])
    diffs = [b - a for a, b in zip(means["off"], means["on"])]
    print(f"host ms a step: {statistics.mean(means['off']):.4f} the tracer off, "
          f"{statistics.mean(means['on']):.4f} on", file=log)

    traced = min(50, max(10, round(run.TRACE_SECONDS / step_s)))
    with profiling.tracing():
        prof = port_trace.profile_steps(trainer.step, traced, sync)

    return {
        "cell": cell_name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "setup_s": setup_s,
        "layout_build_s": None if layout_ns is None else layout_ns / 1e9,
        "kernel_load_s": None if load_ns is None else load_ns / 1e9,
        "setup_counters": setup_counters,
        "blocks": BLOCKS, "steps": STEPS,
        "ops_host_ms": None if ops_ns is None else ops_ns / 1e6 / on_steps,
        "conv_host_ms": None if conv_ns is None else conv_ns / 1e6 / on_steps,
        "host_ms_off": statistics.mean(means["off"]),
        "host_ms_on": statistics.mean(means["on"]),
        "on_cost_ms": [statistics.mean(diffs), statistics.stdev(diffs) / len(diffs) ** 0.5],
        "spans_per_step": len(spans) / on_steps,
        "counters_per_step": counters_per_step,
        "traced_steps": traced,
        "idle_gaps": prof.idle_gaps() if prof.ops else [],
        "idle_gaps_by_span": prof.idle_gaps_by_span() if prof.ops else [],
        "span_us": span_costs(MICRO_CALLS),
    }


def main(argv=None, root=registry.BENCH_DIR, device=None, t_start: float = T_START) -> int:
    """The command line. ``device`` other than None skips the look for a card
    (the CPU tests drive a report so)."""
    args = parse_args(argv)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    line = report(args.workload, args.seed, torch.device(device), root, t_start)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    run.pin_caches()
    sys.exit(main())
