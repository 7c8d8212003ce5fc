"""Serving launcher of the port (``repro.launch.serve``).

* ``--demo``       — serve a seeded request set through the engine at
                     the chosen architecture's reduced width and print
                     the run summary;
* ``--http``       — stand the OpenAI-compatible HTTP front door
                     (DESIGN.md §14) over that engine: the
                     continuous-batching front-end and
                     ``/v1/completions`` with SSE streaming, until
                     interrupted;
* ``--http-smoke`` — start that server on a free loopback port, run one
                     streaming and one non-streaming completion through
                     it, print the result JSON and exit;
* default          — the dry run of the production serve step
                     (``launch/dryrun.py``): ``--shape`` decode_32k,
                     prefill_32k or long_500k on the 16 x 16 mesh
                     (``--multi-pod``: 2 x 16 x 16), per-device FLOPs,
                     bytes, collectives, memory and the H100 roofline;
                     it needs no card.

The serving modes run on the CUDA card unless ``--device cpu`` is
given.  With ``--mesh DxM`` they serve on a ``(data, model)`` mesh of
D*M ranks started by ``torchrun --nproc-per-node D*M``: NCCL, one card a
rank (``--device cpu``: gloo on the CPU), each rank its shards of the
weights, every arch.  ``--demo`` (with ``--prefix-share`` too): every
rank serves the same requests, rank 0 prints the summary; ``--http`` /
``--http-smoke``: rank 0 runs the HTTP server and the front-end, every
other rank follows it (``ServingFrontend.follow``), rank 0 prints the
smoke test's JSON.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --demo
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --demo --paged --prefix-share 0.5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --http --paged --pipelined
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b --shape decode_32k
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch smollm-135m --demo --mesh 1x2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch mamba2-130m --demo --mesh 2x2 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch smollm-135m --http-smoke --mesh 1x2 --device cpu
"""
import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import ServingConfig, SpecDecodeConfig
from repro_torch.core.drafters import available_drafters, build_drafter
from repro_torch.core.policies import available_policies
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.models.weights import init_params, map_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.request import Request
from repro_torch.serving.server import smoke_check, start_http_server_thread


def main(argv: Optional[List[str]] = None) -> Dict:
    """Runs the chosen mode; returns the demo's run summary, the HTTP
    smoke test's result (``--http`` serves until interrupted, then
    returns an empty dict) or the dry run's record (exit 1 if it
    failed)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="decode_32k",
                    choices=["decode_32k", "prefill_32k", "long_500k"],
                    help="dry run (default mode): the serve shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="dry run: the 2 x 16 x 16 mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="dry run: the arch's reduced config")
    ap.add_argument("--demo", action="store_true",
                    help="serve seeded requests at the reduced width")
    ap.add_argument("--http", action="store_true",
                    help="serve the reduced engine over the OpenAI-"
                         "compatible HTTP layer until interrupted")
    ap.add_argument("--http-smoke", action="store_true",
                    help="start the HTTP server on a free port, run one "
                         "streaming and one non-streaming completion, "
                         "print the result JSON, exit")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port")
    ap.add_argument("--policy", default="dsde",
                    choices=list(available_policies()))
    ap.add_argument("--drafter", default="model",
                    choices=list(available_drafters()),
                    help="'model' runs a second draft model; 'ngram' and "
                         "'self' serve with no draft params")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--paged", action="store_true",
                    help="serve from the block-paged KV pool at half the "
                         "dense engine's KV bytes")
    ap.add_argument("--prefix-share", type=float, default=0.0, metavar="S",
                    help="demo only: fraction in [0, 1) of every prompt "
                         "that is a common head; > 0 implies --paged and "
                         "turns on prefix caching")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="paged pool storage; int8 implies --paged")
    ap.add_argument("--slo-deadline", default=None, metavar="BASE,PER_TOK",
                    help="demo only: every request's completion deadline "
                         "is BASE + PER_TOK * max_new_tokens seconds")
    ap.add_argument("--pipelined", action="store_true",
                    help="reconcile the host one round behind the device")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve (--demo, --http, --http-smoke) on a "
                         "(data, model) mesh of the D*M ranks torchrun "
                         "started")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        check_mesh_args(ap, args)
    if not (args.demo or args.http or args.http_smoke):
        # production path: the dry run of the serve step
        rec = dryrun_one(args.arch, args.shape, args.multi_pod,
                         reduced=args.reduced)
        if rec["status"] not in ("ok", "skipped"):
            raise SystemExit(1)
        return rec
    if not 0.0 <= args.prefix_share < 1.0:
        ap.error("--prefix-share must be in [0, 1)")
    deadline = None
    if args.slo_deadline:
        try:
            base_s, per_tok_s = map(float, args.slo_deadline.split(","))
        except ValueError:
            ap.error("--slo-deadline expects BASE,PER_TOK floats")
        deadline = base_s + per_tok_s * args.max_new

    if args.mesh:
        return serve_on_mesh(args, deadline)
    eng, cfg = build_demo_engine(args)
    rng = np.random.RandomState(0)
    if args.http or args.http_smoke:
        return serve_http(args, eng, cfg, rng)
    m = eng.run(demo_requests(args, cfg, rng, deadline))
    print({k: round(v, 3) if isinstance(v, float) else v
           for k, v in m.items()})
    return m


def check_mesh_args(ap, args) -> None:
    """``--mesh``'s refusals, before any process group: a mode that
    serves, and the ranks of torchrun (every arch and serving mode runs
    on a mesh)."""
    if not (args.demo or args.http or args.http_smoke):
        ap.error("--mesh serves --demo, --http or --http-smoke")
    if "RANK" not in os.environ:
        ap.error(f"--mesh {args.mesh} runs under torchrun --nproc-per-node "
                 "D*M")


def serve_on_mesh(args, deadline: Optional[float]) -> Dict:
    """A serving mode on the ``(data, model)`` mesh of the ranks torchrun
    started, every rank over its shards.  The demo: every rank serves the
    same requests, rank 0 prints the summary.  HTTP: rank 0 serves it
    (:func:`serve_http`) and every other rank follows rank 0's front-end
    until it stops (returning an empty dict)."""
    import torch.distributed as dist
    from repro_torch.core.tp import MeshPlan
    from repro_torch.launch.mesh import init_serving_world, serving_mesh

    if args.device == "cpu":
        dist.init_process_group("gloo")
        mesh = serving_mesh(args.mesh, device_type="cpu")
    else:
        init_serving_world()
        mesh = serving_mesh(args.mesh)
    try:
        plan = MeshPlan.for_mesh(mesh, 4)
        eng, cfg = build_demo_engine(args, plan)
        rng = np.random.RandomState(0)
        if args.http or args.http_smoke:
            if dist.get_rank() == 0:
                return serve_http(args, eng, cfg, rng)
            ServingFrontend(eng).follow()
            return {}
        m = eng.run(demo_requests(args, cfg, rng, deadline))
        m["mesh"] = args.mesh
        if dist.get_rank() == 0:
            print({k: round(v, 3) if isinstance(v, float) else v
                   for k, v in m.items()}, flush=True)
        return m
    finally:
        dist.destroy_process_group()


def demo_requests(args, cfg, rng, deadline) -> List[Request]:
    """The demo's seeded requests (with ``--prefix-share`` a common head
    of whole blocks)."""
    head: List[int] = []
    if args.prefix_share > 0:
        # a shared head of whole KV blocks, so that its full blocks are
        # hash-addressable, sized so head / (head + tail) ~= share
        tail = 13                 # mean of the per-request draw below
        n = int(round(args.prefix_share / (1 - args.prefix_share) * tail))
        n = max(n // 16 * 16, 16)
        head = rng.randint(0, cfg.vocab_size, size=n).tolist()
    return [Request(i, prompt=head + rng.randint(
        0, cfg.vocab_size, size=rng.randint(6, 20)).tolist(),
        max_new_tokens=args.max_new, slo_deadline_s=deadline)
        for i in range(args.requests)]


def build_demo_engine(args, plan=None):
    """The engine of every mode: the reduced config, seeded weights
    (target seed 1; a model drafter's draft = target + 0.03 x a seed-7
    draw), batch 4 and 256 tokens, on the ring or, with ``--paged``,
    ``--prefix-share`` or ``--kv-quant``, on a pool of half the ring's
    bytes.  ``plan`` (a ``core.tp.MeshPlan``): the weights are drawn as
    this rank's shards, and the engine serves on its mesh."""
    cfg = get_config(args.arch).reduced()
    pt = init_params(cfg, seed=1, device=args.device, plan=plan)
    spec = SpecDecodeConfig(policy=args.policy, drafter=args.drafter)
    pd = cfg_d = None
    if build_drafter(spec, cfg, cfg).uses_draft_model():
        noise = init_params(cfg, seed=7, device=args.device, plan=plan)
        pd, cfg_d = map_params(lambda a, b: a + 0.03 * b, pt, noise), cfg
    caching = args.prefix_share > 0
    quant = args.kv_quant != "none"
    paged = args.paged or caching or quant
    serving = ServingConfig(
        max_batch_size=4, max_seq_len=256, pipelined=args.pipelined,
        paged_kv=paged, kv_block_size=16, prefix_caching=caching,
        kv_quant=args.kv_quant,
        num_kv_blocks=4 * (256 // 16) // 2 if paged else None)
    return ServingEngine(pt, cfg, pd, cfg_d, spec, serving,
                         device=args.device, mesh=plan), cfg


def serve_http(args, eng, cfg, rng) -> Dict:
    """The front-end's driver thread and the HTTP server over ``eng``:
    self-test and return (``--http-smoke``) or serve until interrupted
    (on a mesh: rank 0's; stopping its front-end stops the followers)."""
    fe = ServingFrontend(eng).start()
    port, stop = start_http_server_thread(
        fe, host=args.host, port=args.port, model_name=args.arch,
        default_max_tokens=args.max_new)
    try:
        if args.http_smoke:
            prompt = rng.randint(0, cfg.vocab_size, size=8).tolist()
            out = smoke_check(args.host, port, prompt, max_tokens=8)
            out["port"] = port
            if args.mesh:
                out["mesh"] = args.mesh
            out["summary"] = {
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in fe.summary().items()
                if k in ("requests_finished", "tokens_emitted", "rounds",
                         "ttft_mean_s", "queue_depth_peak", "device")}
            print(json.dumps(out))
            return out
        print(f"serving {args.arch} ({args.drafter} drafter, {args.policy} "
              f"policy) on http://{args.host}:{port}/v1/completions",
              flush=True)
        while True:             # the server and the driver run on daemons
            time.sleep(3600)
    except KeyboardInterrupt:
        return {}
    finally:
        stop()
        fe.stop()


if __name__ == "__main__":
    main()
