"""The benchmark of the PyTorch / CUDA port (`tmlqcd_tpu_torch`) on one card.

    python3 qcdbench/run.py --workload NAME --seed N --seconds S --trace 0|1

finds the cell NAME in BENCHMARK.json, its configuration file, its traffic
file `qcdbench/traffic/<traffic>.json`, its limits `qcdbench/limits/<cell>.json`
and one reader `qcdbench/metrics/<metric>.py` per metric, all by name
(README.md says how to add each).  It makes every input from the seed (or
the cached smooth field), warms up the cell's own shapes, runs units (HMC
trajectories or propagators, `workload.py`) back to back for S seconds,
checks what the window produced against the plain reference
(`reference/`), and prints one JSON line.  The window runs from the first
unit's start to the end of the last unit completed inside S; a unit that
would end after the cut at the mean length so far is not started, one
still running at the cut is abandoned.  With --trace 0 the line holds the
end-to-end metrics.  With --trace 1 a second window of S seconds follows
under torch.profiler, and the line holds the per-layer metrics (those on the
host's clock read the untraced window, those of the device the traced one),
the device's busy time and a breakdown; the check covers both windows.

--root DIR takes BENCHMARK.json and the data files from another tree, and
--cpu runs the program's plain CPU routes (both for tests only).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the harness's modules, then the checkout's root, which holds the program
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "tmlqcd_tpu")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(path: str):
    spec = importlib.util.spec_from_file_location(
        "qcdbench_metric_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counters() -> dict:
    """The port's launch and hop counters: every int attribute of the
    functions of `ops.dslash_cuda`."""
    from tmlqcd_tpu_torch.ops import dslash_cuda as dc

    out = {}
    for fname, fobj in vars(dc).items():
        if callable(fobj) and hasattr(fobj, "__dict__"):
            for attr, v in vars(fobj).items():
                if isinstance(v, int) and not isinstance(v, bool):
                    out[f"{fname}.{attr}"] = v
    return out


def window(w, seconds: float, k0: int, before: dict):
    """Units k0, k0 + 1, ... back to back for `seconds`: (the records of the
    units completed inside it, the seconds from the first unit's start to
    the last completed unit's end, the port's counters over those units,
    the next unit's k).  A unit that would end after the cut at the mean
    length so far is not started; one still running at the cut is
    abandoned."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    records, t_last, after = [], t0, before
    k = k0
    while True:
        elapsed = time.perf_counter() - t0
        # back to back from t0, so the mean is elapsed / units
        if elapsed >= seconds or (records and elapsed * (1 + 1 / len(records)) > seconds):
            break
        with record_function("qcdbench.unit"):
            rec = w.unit(k)
        t = time.perf_counter()
        k += 1
        if t - t0 > seconds:
            log(f"[window] unit {k - 1} ended {t - t0 - seconds:.2f} s after the cut: abandoned")
            w.abandon()
            break
        records.append(rec)
        t_last, after = t, counters()
    return records, t_last - t0, {n: after[n] - before.get(n, 0) for n in after}, k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    with open(os.path.join(args.root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r}; have {sorted(cells)}")
        return 2
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    data = os.path.join(args.root, bench["paths"][0])
    with open(os.path.join(args.root, conf["file"])) as fh:
        cfg = json.load(fh)
    cfg["_path"] = os.path.join(args.root, conf["file"])
    with open(os.path.join(data, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(data, "limits", args.workload + ".json")) as fh:
        limits = json.load(fh)
    metrics = bench["per_layer"] if args.trace else bench["end_to_end"]
    metrics = [m for m in metrics if applies(m, args.workload)]
    readers = {m["name"]: load_reader(os.path.join(data, "metrics", m["name"] + ".py"))
               for m in metrics}

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"the cell needs {cell['chips']} CUDA device(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import workload

    t_imp = time.perf_counter()
    w = workload.make(traffic["kind"], cfg, traffic, args.seed, device, log)
    t_make = time.perf_counter()
    w.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize()
    before = counters()
    log(f"[setup] imports and device {t_imp - T_START:.2f} s, inputs and program state "
        f"{t_make - t_imp:.2f} s, warm-up {time.perf_counter() - t_make:.2f} s")

    t0 = time.perf_counter()
    setup_s = t0 - T_START
    records, window_s, counted, k = window(w, args.seconds, 0, before)
    if not records:
        log("no unit completed inside the window")
        return 4
    traced = trace = None
    if args.trace:
        # a second window of the same length under torch.profiler: the
        # device metrics read it, the host-clock ones the untraced window
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t_records, _, t_counted, _ = window(w, args.seconds, k, counters())
        if not t_records:
            log("no unit completed inside the traced window")
            return 4
        traced = types.SimpleNamespace(records=t_records, units=len(t_records),
                                       counters=t_counted)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 5

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced is not None:
        import devtrace

        t_r = time.perf_counter()
        trace = devtrace.reduce(prof, traced.units)
        prof = None
        log(f"[trace] reduced in {time.perf_counter() - t_r:.1f} s: window "
            f"{trace.window_s:.3f} s, busy {trace.busy_s:.3f} s")

    import yardstick

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, records=records, units=len(records),
        counters=counted, trace=trace, traced=traced, cfg=cfg, traffic=traffic,
        workload=args.workload, dims=workload.fields.dims_of(cfg), yardstick=yardstick, log=log)
    values = {}
    for m in metrics:
        v = readers[m["name"]](ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"[window] {len(records)} units in {window_s:.3f} s, set-up {setup_s:.3f} s")
    if traced is not None:
        records = records + traced.records

    w.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    numbers = w.check(records, args.seed)
    log(f"[check] {time.perf_counter() - t_c:.1f} s")
    check = {name: {"value": v, "limit": limits[name]} for name, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in check.values())

    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(1 for r in records if r["failed"]),
        "metrics": values,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    result["check"] = check
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 5
    for name, c in check.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
