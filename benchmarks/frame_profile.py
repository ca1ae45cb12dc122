"""Device time per ray class of the default frame, from a profiler trace.

    python benchmarks/frame_profile.py OUT_DIR [--bands 8 1]

Renders the reference's default workload (1024x576, 2 spp, 2+1 bounces,
sun, denoiser) on the default scene through VoxelRT and:

1. times each `TraceConfig.row_bands` value given by --bands, in turns
   (A B B A ...), 5 synced frames per turn, printing the median ms/frame;
2. traces one frame of the first value with `jax.profiler`, writes the
   trace and the step's compiled HLO text under OUT_DIR, and prints the
   reduction below.

The reduction (`reduce_trace`) attributes each device event to a named
scope of ops.trace and the engine step: traverse_primary,
traverse_bounce{i}, traverse_shadow{i}, shading (the rest of ray_color),
denoise, accumulate, other, and between_loops (command-buffer kernels
between two traversals). It also reports each traversal's loop
iterations, the device's busy time (the union of event intervals), its
idle share of the traced window, and the count of host<->device copies
(XLA copies each while_loop predicate to the host once per iteration). Re-run it on a saved trace with
`python benchmarks/frame_profile.py --reduce TRACE.xplane.pb HLO.txt`.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import os
import re
import statistics
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

_SCOPE = re.compile(r"(traverse_(?:primary|bounce\d+|shadow\d+))/")
_OP = re.compile(r'^\s*(?:ROOT )?%([\w.\-]+) = .*op_name="([^"]*)"')


def op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata, from compiled HLO text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _OP.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def classify(op_name: str) -> str:
    m = _SCOPE.search(op_name)
    if m:
        return m.group(1)
    for scope in ("ray_color", "denoise", "accumulate"):
        if f"{scope}/" in op_name:
            return "shading" if scope == "ray_color" else scope
    return "other"


def _union_ns(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def reduce_trace(xplane_path: str, hlo_text: str,
                 plane_prefix: str = "/device:GPU:") -> dict:
    """Device ms per class, busy ms, window ms and idle share of a trace.

    Events are taken from the planes whose name starts with
    `plane_prefix` (on the CPU backend XLA's ops run on "/host:CPU").

    XLA deduplicates identical computations, so a loop body or condition
    shared by several traversals carries one traversal's metadata, and
    kernels replayed from a command buffer (CUDA graph) name no HLO
    instruction at all. The one reliable anchor is the predicate copy
    that ends each iteration: its `hlo_op` is the `while` instruction
    itself. So every event since the previous copy of the SAME loop is
    charged to that loop's class; events between two different loops are
    charged by their own metadata, or to "between_loops" when they come
    from a command buffer."""
    from jax.profiler import ProfileData

    names = op_names(hlo_text)
    per_class = collections.Counter()
    iterations = collections.Counter()
    copies = collections.Counter()
    events = []
    pd = ProfileData.from_file(xplane_path)
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None and "memcpy" not in ev.name.lower():
                    continue
                events.append((float(ev.start_ns), float(ev.duration_ns),
                               ev.name, None if op is None else str(op)))
    if not events:
        raise ValueError(f"no events on planes {plane_prefix!r}*")
    events.sort()

    def own_class(op):
        if op is None or op == "command_buffer":
            return "between_loops"
        return classify(names.get(op, ""))

    pending, last_loop = [], None
    for ev in events:
        start, dur, name, op = ev
        if "memcpy" in name.lower():
            copies[name] += 1
        if name == "MemcpyD2H" and op and op.startswith("while"):
            cls = classify(names.get(op, ""))
            iterations[cls] += 1
            for _, d, _, p in pending:
                per_class[cls if op == last_loop else own_class(p)] += d
            per_class[cls] += dur
            pending, last_loop = [], op
        else:
            pending.append(ev)
    for _, d, _, p in pending:
        per_class[own_class(p)] += d
    intervals = [(s, s + d) for s, d, _, _ in events]
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _union_ns(intervals)
    return {"class_ms": {k: v / 1e6 for k, v in sorted(per_class.items())},
            "busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "iterations": dict(sorted(iterations.items())),
            "copies": dict(copies)}


def _print_reduction(r: dict) -> None:
    total = sum(r["class_ms"].values())
    for k, v in r["class_ms"].items():
        iters = r["iterations"].get(k)
        print(f"  {k:18s} {v:10.3f} ms  {100 * v / total:5.1f}%"
              + (f"  {iters} loop iterations" if iters else ""))
    print(f"  busy {r['busy_ms']:.3f} ms of a {r['window_ms']:.3f} ms window "
          f"(idle share {r['idle_share']:.4f}); copies {r['copies']}")


def _engine(scene, row_bands: int):
    import dataclasses

    import chip_smoke
    from zig_vulkan_jax.engine.engine import VoxelRT

    cfg = chip_smoke.default_workload_config()
    cfg = dataclasses.replace(
        cfg, trace=dataclasses.replace(cfg.trace, row_bands=row_bands))
    return VoxelRT(scene.grid, scene.materials, cfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir", nargs="?")
    p.add_argument("--bands", type=int, nargs="+", default=[8])
    p.add_argument("--reduce", nargs=2, metavar=("XPLANE", "HLO"))
    args = p.parse_args(argv)
    if args.reduce:
        opener = gzip.open if args.reduce[1].endswith(".gz") else open
        with opener(args.reduce[1], "rt") as f:
            _print_reduction(reduce_trace(args.reduce[0], f.read()))
        return 0

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from zig_vulkan_jax.utils import jitcache

    chip_smoke.require_gpus(1)
    jitcache.enable()
    for line in chip_smoke.card_lines():
        print(f"card: {line}")
    scene = chip_smoke.load_scene()
    engines = {b: _engine(scene, b) for b in args.bands}
    for b, rt in engines.items():
        t0 = time.perf_counter()
        rt.render().block_until_ready()
        print(f"row_bands={b}: first frame {time.perf_counter() - t0:.2f} s")
    order = [b for i in range(2) for b in
             (args.bands if i % 2 == 0 else args.bands[::-1])]
    times = collections.defaultdict(list)
    for b in order:
        times[b] += chip_smoke.frame_ms(engines[b].render, 5)
    for b in args.bands:
        t = times[b]
        print(f"row_bands={b}: median {statistics.median(t):.2f} ms/frame "
              f"(min {min(t):.2f}, max {max(t):.2f}, {len(t)} frames)")

    rt = engines[args.bands[0]]
    os.makedirs(args.out_dir, exist_ok=True)
    trace_dir = os.path.join(args.out_dir, "trace")
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        rt.render().block_until_ready()
        wall = (time.perf_counter() - t0) * 1e3
    xplane = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    step = rt._build_step(rt._step_key())
    hlo = step.lower(rt.arrays, rt._tables, rt.mats,
                     jnp.asarray(rt._push_constants())).compile().as_text()
    with gzip.open(os.path.join(args.out_dir, "step_hlo.txt.gz"), "wt") as f:
        f.write(hlo)
    print(f"traced frame (row_bands={args.bands[0]}): {wall:.2f} ms wall; "
          f"trace {xplane}")
    _print_reduction(reduce_trace(xplane, hlo))
    return 0


if __name__ == "__main__":
    sys.exit(main())
