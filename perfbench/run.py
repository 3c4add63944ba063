"""Run one cell of the port's benchmark and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `BENCHMARK.json`'s `workloads`. Everything about it
is found by name: its configuration in `perfbench/configs/<config>.json`,
its traffic mix in `perfbench/traffic/<traffic>.json`, whose `kind` names
the general driver `perfbench/kinds/<kind>.py`, and each per-layer metric's
reader in `perfbench/metrics/<metric>.py`. A run sets up (counted in
`setup_s`), measures for `--seconds`, checks what the timed path produced
against the plain reference under `perfbench/reference/`, and prints as
its last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checked`, each compared number with its limit (also the last lines of
standard error).

The controls, each a lower precision that `correct` must reject: `--control
tf32` runs the program with TF32 products switched on (it pins them off);
`--control bf16` puts the reference computed in bfloat16 in the program's
place (the scan). The benchmark's own runs never pass either;
`perfbench/tests/` does.

Without a card, or with fewer cards than the cell asks for, the run stops
with a nonzero exit code and prints no result; so does a run whose process
holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "bliss_tpu")

CONTROLS = ("tf32", "bf16")


class NoCard(RuntimeError):
    pass


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_reader(name: str):
    """The `read(view)` of `perfbench/metrics/<name>.py` (a metric's name
    may hold dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether `metric` belongs to `cell`: its `workloads` name the cell;
    without that key, an end-to-end metric belongs to every cell and a
    per-layer one to every cell that reports the metric it `moves`."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def forbidden_loaded() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Ctx:
    """One run: the cell's entries, its arguments and what set-up recorded."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    control: str | None = None
    setup: dict = field(default_factory=dict)
    lines: list = field(default_factory=list)

    def log(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    def part(self, name: str, t0: float) -> float:
        """Record the set-up part `name` that began at `t0`; returns now."""
        now = time.perf_counter()
        self.setup[name] = now - t0
        return now


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(name: str, seed: int, seconds: float, trace: bool, control=None,
             device=None, overrides=None, bench=None) -> dict:
    """Run cell `name` and return its result object. `device` None is the
    card (`cuda:0`), which must be there; the tests pass "cpu" with
    `overrides`, a dict of `config` and `traffic` entries to replace.
    `bench` stands for `BENCHMARK.json` (the tests add a cell that it does
    not hold)."""
    import torch

    bench = bench or benchmark()
    cell = find(bench["workloads"], name, "workload")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    for key, values in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(values)
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise NoCard(f"{torch.cuda.device_count()} cards visible, the cell asks for {cell['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if control is not None and control not in CONTROLS:
        raise ValueError(f"control {control!r}: one of {CONTROLS}")
    ctx = Ctx(cell, config, traffic, seed, float(seconds), trace, device, control)
    kind = importlib.import_module(f"perfbench.kinds.{traffic['kind']}")
    import bliss_tpu_torch  # noqa: F401  (pins TF32 off on import)

    ctx.setup["import"] = time.perf_counter() - T_START
    pinned = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        out = kind.run(ctx)
    finally:  # a control leaves the next run of the process as the program pins it
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = pinned
    setup_s = out["window_start"] - T_START

    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    values = dict(out["e2e"], setup_s=setup_s)
    if trace:
        view = out["view"]
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, name, {e["name"] for e in e2e}):
                value = load_reader(m["name"])(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}

    checks = out["checks"]
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(v <= limit for v, limit in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        from .trace import breakdown

        dev["busy_s"] = out["view"].busy_s()
        dev["window_s"] = out["view"].window_s
        result["breakdown"] = breakdown(out["view"])
    for part, secs in ctx.setup.items():
        ctx.log(f"setup {part}: {secs:.3f} s")
    ctx.log(f"setup_s {setup_s:.3f} s; card {card_line() if device.type == 'cuda' else 'cpu'}")
    for line in ctx.lines:
        ctx.log(line)
    result["checked"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    for k, (v, limit) in checks.items():
        ctx.log(f"check {k} {v!r} limit {limit!r} {'ok' if v <= limit else 'FAILED'}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, default=None)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), args.control)
    except NoCard as e:
        print(f"perfbench: no card to run on: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"perfbench: the run's process holds {found}", file=sys.stderr, flush=True)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
