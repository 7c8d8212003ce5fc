"""The port's dry run (``repro.launch.dryrun``): the per-device cost of
every (architecture x input shape) step on the production mesh, without
a card.

For each combination it builds the port's real step
(``launch/steps.py``) on the 16 x 16 ``(data, model)`` mesh, or 2 x 16 x
16 ``(pod, data, model)`` with ``--multi-pod``, over a fake process group
(``launch/mesh.py``), and runs it once on stand-in tensors that hold no
memory: DTensors over the fake shards of ``launch.op_cost.OpCounter``.
The counter sees each device's local ops, so every figure is per device:

* FLOPs, bytes (the port's eager traffic, an upper bound on a fused
  program's) and collective bytes by kind;
* the hand-written kernels' calls, FLOPs and bytes, costed by their own
  formulas (``kernels/shape_only.py``);
* memory: argument, output (storages the step allocates for its
  results), temporary (peak less arguments) and peak bytes, and the peak
  as a share of the card's 80 GB;
* a roofline on the H100 SXM's data-sheet figures
  (``core.config.H100_SXM``, :func:`roofline`): compute, memory and
  collective times, the bottleneck, and the useful share of the FLOPs
  (the model's 6·N·D count over the counted ones).  The memory time is
  that of the bytes the step must move (its arguments read once, its
  new outputs written once); the counted eager traffic, which holds
  every intermediate, has its own time, ``eager_memory_s``, and is not
  the bound.

These are predictions of a cost model, not measurements.  The record
keeps the reference's keys where their meaning holds; ``flops_per_device``
and ``bytes_per_device`` replace its ``hlo_*`` keys, and the keys that
only XLA on a CPU has (``xla_cost_analysis_raw``,
``cpu_bf16_artifact_bytes_est``, ``temp_tpu_adjusted_bytes``) are gone.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out results.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import H100_SXM, INPUT_SHAPES
from repro_torch.launch.mesh import (fake_device_type, fake_world,
                                     make_mesh_from_shape, production_shape)
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import (adapt_config, make_step_and_specs,
                                      model_flops, supported)

# loggers that report every op DTensor or the fake mode declines before
# it takes another route, and the fake group's fallbacks
_NOISY = ("torch._subclasses.fake_tensor", "torch.distributed",
          "torch.distributed.tensor")


@contextlib.contextmanager
def _quiet():
    levels = [(lg, lg.level) for lg in map(logging.getLogger, _NOISY)]
    for lg, _ in levels:
        lg.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        for lg, level in levels:
            lg.setLevel(level)


def collective_bandwidth(devices: int) -> float:
    """The link rate the collective term uses: NVLink when the whole mesh
    fits in one node, else the inter-node rate (every axis of the
    production mesh has groups that span nodes)."""
    hw = H100_SXM
    return hw.nvlink_bandwidth if devices <= hw.gpus_per_node \
        else hw.network_bandwidth


def roofline(rec: Dict, devices: int,
             model_flops_per_device: float = 0.0) -> Dict:
    """The roofline of a :func:`measure` record on ``devices`` cards:
    ``compute_s`` (its FLOPs at the bf16 peak), ``memory_s`` (the bytes
    the step must move, arguments plus new outputs, at the HBM rate),
    ``collective_s``, the ``bottleneck`` among the three,
    ``eager_memory_s`` (the counted eager traffic at the HBM rate, an
    upper bound, not a term of the bound) and ``useful_flops_ratio``."""
    hw, mem = H100_SXM, rec["memory"]
    terms = {"compute": rec["flops"] / hw.peak_flops_bf16,
             "memory": (mem["argument_bytes"] + mem["output_bytes"])
             / hw.hbm_bandwidth,
             "collective": rec["collective_bytes"]
             / collective_bandwidth(devices)}
    flops = rec["flops"]
    return {**{k + "_s": v for k, v in terms.items()},
            "bottleneck": max(terms, key=terms.get),
            "eager_memory_s": rec["bytes"] / hw.hbm_bandwidth,
            "useful_flops_ratio": (model_flops_per_device / flops
                                   if flops else None)}


def measure(cfg, shape, mesh, rules, *, opts: frozenset = frozenset(),
            weighted: bool = True, batch: Optional[int] = None,
            seq_len: Optional[int] = None, with_step: bool = False):
    """Build the step of ``cfg`` at ``shape`` on ``mesh`` and run it on
    stand-ins under an :class:`OpCounter`: the counts, and the memory
    record (bytes per device); with ``with_step``, (record, the step
    function)."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = OpCounter(weighted=weighted)
    with counter, implicit_replication():
        with counter.paused():
            step, args, _ = make_step_and_specs(
                cfg, shape, mesh, rules, opts=opts,
                device=fake_device_type(), batch=batch, seq_len=seq_len)
        arg_bytes = counter.track_args(args)
        out = step(*args)
        out_bytes = counter.fresh_bytes(out) - _shared(counter, out, args)
        del out, args
    rec = counter.report()
    rec["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": counter.peak - arg_bytes,
        "peak_bytes": counter.peak,
    }
    return (rec, step) if with_step else rec


def one_card(arch: str, shape_name: str, *, batch: int, seq_len: int,
             opts: frozenset = frozenset(), reduced: bool = False):
    """The dry run of one step on a 1 x 1 mesh at ``batch`` x ``seq_len``
    (the one-card check of ``chip_smoke.py``): (its record, with its
    ``roofline``; the step function, which runs as well on real
    tensors: ``steps.concrete_args``)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    cfg = adapt_config(cfg, shape, opts)
    with _quiet(), fake_world(1):
        mesh = make_mesh_from_shape((1, 1), ("data", "model"))
        rec, step = measure(cfg, shape, mesh, make_rules(mesh, shape),
                            opts=opts, batch=batch, seq_len=seq_len,
                            with_step=True)
    rec["roofline"] = roofline(rec, 1)
    return rec, step


def _shared(counter: OpCounter, out, args) -> float:
    """Bytes of the output storages that are argument storages (written
    in place: the donated caches)."""
    from repro_torch.launch.op_cost import _local, _tensors
    arg_ids = {id(_local(t).untyped_storage()) for t in _tensors(args)}
    seen, total = set(), 0.0
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        if id(st) in arg_ids and id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               verbose: bool = True, opts: frozenset = frozenset(),
               expert_parallel: bool = False, reduced: bool = False) -> Dict:
    """The dry-run record of ``arch`` x ``shape_name`` on the production
    mesh (module docstring); ``reduced`` takes the arch's ``reduced()``
    config.  A combination the reference skips comes back
    ``skipped``."""
    shape = INPUT_SHAPES[shape_name]
    cfg0 = get_config(arch).reduced() if reduced else get_config(arch)
    ok, why = supported(cfg0, shape)
    ms = production_shape(multi_pod)
    sizes, axes = ms.shape, ms.axis_names
    rec: Dict = {"arch": arch, "shape": shape_name,
                 "mesh": "x".join(map(str, sizes)),
                 "opts": sorted(opts) + (["ep"] if expert_parallel else [])
                 + (["reduced"] if reduced else [])}
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[SKIP] {arch} x {shape_name}: {why}")
        return rec

    n_dev = math.prod(sizes)
    t0 = time.monotonic()
    with _quiet(), fake_world(n_dev):
        mesh = make_mesh_from_shape(sizes, axes)
        rules = make_rules(mesh, shape, expert_parallel=expert_parallel)
        cfg = adapt_config(cfg0, shape, opts)
        counts = measure(cfg, shape, mesh, rules, opts=opts)
    t1 = time.monotonic()

    flops, nbytes = counts["flops"], counts["bytes"]
    coll = counts["collective_bytes"]
    mf = model_flops(cfg0, shape)
    mem = counts["memory"]
    mem["peak_share_of_hbm"] = mem["peak_bytes"] / H100_SXM.hbm_bytes
    rec.update(
        status="ok",
        devices=n_dev,
        fake_device=fake_device_type(),
        trace_s=round(t1 - t0, 2),
        flops_per_device=flops,
        bytes_per_device=nbytes,
        collective_bytes_per_device=coll,
        collectives=counts["collectives"],
        kernel_calls=counts["kernel_calls"],
        kernel_flops_per_device=counts["kernel_flops"],
        kernel_bytes_per_device=counts["kernel_bytes"],
        ops_per_device=counts["ops"],
        memory=mem,
        model_flops_total=mf,
        model_flops_per_device=mf / n_dev,
        hardware=H100_SXM.name,
        roofline=roofline(counts, n_dev, mf / n_dev),
    )
    if verbose:
        r = rec["roofline"]
        print(f"[OK]   {arch:22s} x {shape_name:12s} mesh={rec['mesh']:8s} "
              f"trace={rec['trace_s']:6.1f}s FLOPs/dev={flops:.3e} "
              f"bytes/dev={nbytes:.3e} coll/dev={coll:.3e} "
              f"terms(c/m/n)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
              f"{r['collective_s']:.2e} -> {r['bottleneck']}")
        print(f"       memory: args={mem['argument_bytes'] / 2**30:.2f}GiB "
              f"out={mem['output_bytes'] / 2**30:.2f}GiB "
              f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
              f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
              f"({100 * mem['peak_share_of_hbm']:.1f}% of "
              f"{H100_SXM.hbm_bytes / 1e9:.0f} GB) (per device)")
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every non-paper arch x every shape")
    ap.add_argument("--opt", action="append", default=[],
                    help="a §Perf variant (verify, kv_pad, head_pad, mbN)")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output path (merged)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    assigned = [a for a in list_archs() if not a.startswith("paper-")]
    combos = ([(a, s) for a in assigned for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    results = []
    t0 = time.monotonic()
    for arch, shape in combos:
        try:
            rec = dryrun_one(arch, shape, args.multi_pod,
                             opts=frozenset(args.opt),
                             expert_parallel=args.expert_parallel)
        except Exception as e:  # a failure here is a bug in the port
            ms = production_shape(args.multi_pod)
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "mesh": "x".join(map(str, ms.shape)),
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {arch} x {shape}: {rec['error']}")
        results.append(rec)
        if args.out:
            existing = []
            if os.path.exists(args.out):
                with open(args.out) as f:
                    existing = json.load(f)
            keep = [r for r in existing
                    if not (r["arch"] == rec["arch"]
                            and r["shape"] == rec["shape"]
                            and r.get("mesh") == rec.get("mesh"))]
            with open(args.out, "w") as f:
                json.dump(keep + [rec], f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results) - len(bad)}/{len(results)} combos OK "
          f"in {time.monotonic() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
