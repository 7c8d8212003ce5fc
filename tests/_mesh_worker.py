"""One rank of a serving-mesh world on the CPU, for
``tests/test_torch_serving_mesh.py`` (imports no jax).

    python tests/_mesh_worker.py RANK WORLD STORE JOB OUT

The ranks meet over a gloo ``FileStore`` at STORE, build the ``DxM``
``DeviceMesh`` that JOB names and run its cases in order, every rank the
same.  JOB (``torch.save``) holds ``mesh``, ``configs`` (name ->
``ModelConfig`` field overrides of ``smollm-135m.reduced()``, or of the
reduced config, or its ``draft()``, of the arch an ``arch`` / ``draft_of``
key names), ``params`` (name -> a whole parameter tree of numpy arrays)
and ``cases`` (dicts, by ``kind``: ``serve`` (a warm prefix cache's
waves too), ``frontend``, ``http``, ``forward``, ``layout``).
OUT gets this rank's results, one per case, by case name, and under
``seconds`` each case's wall time.
"""
import dataclasses
import hashlib
import os
import sys
import time

import torch
import torch.distributed as dist


def config(overrides):
    from repro_torch.configs import get_config
    overrides = dict(overrides)
    draft_of = overrides.pop("draft_of", None)
    cfg = get_config(draft_of or overrides.pop("arch", "smollm-135m")
                     ).reduced()
    return dataclasses.replace(cfg.draft() if draft_of else cfg, **overrides)


def count_drops():
    """Wrap the MoE block's dispatch so that each call that drops a
    (token, slot) pair is counted (a host read of the test's own)."""
    from repro_torch.models import moe
    calls = {"calls": 0, "dropping": 0}
    inner = moe._moe_local

    def wrapped(*a, **kw):
        y, aux = inner(*a, **kw)
        calls["calls"] += 1
        calls["dropping"] += int(float(aux["dropped_fraction"]) > 0)
        return y, aux
    moe._moe_local = wrapped
    return calls, lambda: setattr(moe, "_moe_local", inner)


def params_of(job, name):
    from repro_torch.models.weights import from_reference
    return from_reference(job["params"][name], device="cpu")


def engine_of(job, case, mesh):
    """The engine a serving case names (``caching``: prefix caching on
    the pool), on ``mesh`` unless the case is ``unmeshed``."""
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.serving.engine import ServingEngine

    cfg = config(job["configs"][case.get("config", "small")])
    cfg_d = (config(job["configs"][case["draft_config"]])
             if "draft_config" in case else cfg)
    model = case.get("drafter", "model") == "model"
    spec = SpecDecodeConfig(policy=case.get("policy", "dsde"),
                            drafter=case.get("drafter", "model"),
                            temperature=0.0,
                            self_draft_layers=case.get("self_layers", 1),
                            **({"ngram_n": case["ngram_n"]}
                               if "ngram_n" in case else {}))
    sv = ServingConfig(max_batch_size=case.get("batch", 2),
                       max_seq_len=case.get("max_seq", 128),
                       paged_kv=case.get("paged", False),
                       kv_block_size=case.get("bs", 16),
                       num_kv_blocks=case.get("nblocks"),
                       pipelined=case.get("pipelined", False),
                       kv_quant=case.get("kv_quant", "none"),
                       prefix_caching=case.get("caching", False))
    pt = params_of(job, case.get("target", "pt"))
    pd = params_of(job, case.get("draft", "pd")) if model else None
    return ServingEngine(pt, cfg, pd, cfg_d if model else None, spec, sv,
                         seed=0, device="cpu",
                         mesh=None if case.get("unmeshed") else mesh)


def host_reads(eng):
    """Count the host reads of tensors (``item``, ``tolist``, ``numpy``,
    ``bool`` / ``int`` / ``float``) that ``eng.dispatch`` makes: the
    calls that would synchronise a card (the CPU's stand-in for its sync
    count).  ``core/tp.py``'s reads of the control group's host tensors
    (rank 0's clock) are not counted: they live on the host on a card
    too."""
    counts = {"reads": 0}
    dispatch = eng.dispatch
    names = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__")

    def watched():
        own = {n: torch.Tensor.__dict__.get(n) for n in names}
        inner = {n: getattr(torch.Tensor, n) for n in names}

        def counting(name):
            def read(self, *a, **kw):
                caller = sys._getframe(1).f_code.co_filename
                if not caller.endswith(os.path.join("core", "tp.py")):
                    counts["reads"] += 1
                return inner[name](self, *a, **kw)
            return read
        for n in names:
            setattr(torch.Tensor, n, counting(n))
        try:
            return dispatch()
        finally:
            for n, f in own.items():
                if f is None:
                    delattr(torch.Tensor, n)
                else:
                    setattr(torch.Tensor, n, f)
    eng.dispatch = watched
    return counts


def summary_of(eng, m, reqs, case):
    """What a serving case returns: streams, the run's counts, this
    rank's collectives and dispatch host reads, the prefix cache's
    totals and (``digest``) the pool's digests."""
    from repro_torch.core import tp
    sched = eng.scheduler
    out = {"streams": [r.output for r in reqs],
           "finished": m["requests_finished"],
           "preemptions": m["preemptions"], "rounds": m["rounds"],
           "admit_order": [r.admit_seq for r in reqs],
           "slots": [r.slot for r in reqs],
           "slo_predicted_violations": m["slo_predicted_violations"],
           "slo_deferrals": m["slo_deferrals"],
           "counts": dict(tp.COUNTS),
           "prefix": {"hit_blocks": m["prefix_cache_hit_blocks"],
                      "cow_copies": m["cow_copies"],
                      "hit_rate": m["prefix_cache_hit_rate"],
                      "tokens": sched.prefix_tokens_total,
                      "hit_tokens": sched.prefix_hit_tokens_total}}
    if case.get("digest"):
        tc = eng.state.target_cache
        out["pool_digest"] = {
            k: hashlib.sha256(tc[k].contiguous().numpy().tobytes()).hexdigest()
            for k in ("k", "v", "kv_pos", "block_table", "k_scale", "v_scale")
            if k in tc}
    return out


def serve(job, case, mesh):
    """``run()`` over the case's ``prompts`` (or, with ``batches``, each
    batch in turn on one engine: a warm prefix cache's waves)."""
    from repro_torch.core import tp
    from repro_torch.serving.request import Request

    skew = case.get("skew", {}).get(str(dist.get_rank()))
    real = time.monotonic
    if skew is not None:
        time.monotonic = lambda: real() + skew
    drops, undo = count_drops() if case.get("drops") else (None, None)
    try:
        eng = engine_of(job, case, mesh)
        reads = host_reads(eng)
        deadlines = case.get("deadlines")
        batches = case.get("batches", [case.get("prompts")])
        tp.reset_counts()
        reqs = []
        for j, batch in enumerate(batches):
            rs = [Request(100 * j + i, prompt=list(p),
                          max_new_tokens=case.get("max_new", 10),
                          slo_deadline_s=None if deadlines is None
                          else deadlines[i])
                  for i, p in enumerate(batch)]
            m = eng.run(rs)
            reqs += rs
    finally:
        time.monotonic = real
        if undo is not None:
            undo()
    out = summary_of(eng, m, reqs, case)
    out.update(drops=drops, dispatch_reads=reads["reads"])
    st = eng.state
    if case.get("shapes"):
        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                return [shapes(v) for v in tree]
            return tuple(tree.shape) if hasattr(tree, "shape") else None
        out["shapes"] = {"pt": shapes(eng.pt), "pd": shapes(eng.pd),
                         "target_cache": shapes(st.target_cache),
                         "draft_cache": shapes(st.draft_cache),
                         "control": {k: tuple(getattr(st, k).shape) for k in
                                     ("pending", "sl_next", "seed",
                                      "round_idx", "done", "tokens_budget",
                                      "eos_id")}}
    return out


def frontend_case(job, case, mesh):
    """The meshed ``ServingFrontend``: rank 0 takes the case's prompts
    (``mode`` ``replay``: all before ``run_until_drained``; ``threaded``:
    the driver thread started first, one submission every 10 ms), every
    other rank follows.  Rank 0 returns its handles' streams and whether
    each handle's events rebuild its request's output (each token once,
    in order); a follower the streams of the requests it served."""
    from repro_torch.core import tp
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.request import Request

    skew = case.get("skew", {}).get(str(dist.get_rank()))
    real = time.monotonic
    if skew is not None:
        time.monotonic = lambda: real() + skew
    try:
        eng = engine_of(job, case, mesh)
        reads = host_reads(eng)
        fe = ServingFrontend(eng)
        tp.reset_counts()
        reqs = [Request(i, prompt=list(p),
                        max_new_tokens=case.get("max_new", 10))
                for i, p in enumerate(case["prompts"])]
        if not fe.leader:
            done = sorted(fe.follow(), key=lambda r: r.request_id)
            return {"streams": [r.output for r in done],
                    "leader": False, "dispatch_reads": reads["reads"],
                    "counts": dict(tp.COUNTS)}
        if case["mode"] == "replay":
            handles = [fe.submit_request(r) for r in reqs]
            fe.run_until_drained()
            fe.stop()
        else:
            fe.start()
            handles = []
            for r in reqs:
                handles.append(fe.submit_request(r))
                time.sleep(0.01)
            if not fe.wait_idle(timeout=300):
                raise RuntimeError("the meshed front-end did not go idle")
            fe.stop()
    finally:
        time.monotonic = real
    results = [h.result(timeout=30) for h in handles]
    return {"streams": [toks for toks, _ in results], "leader": True,
            "once_in_order": all(toks == h.request.output
                                 for (toks, _), h in zip(results, handles)),
            "finish_reasons": [reason for _, reason in results],
            "summary": {k: fe.summary()[k] for k in (
                "requests_finished", "prefix_cache_hit_blocks",
                "cow_copies")},
            "dispatch_reads": reads["reads"], "counts": dict(tp.COUNTS)}


def http_case(job, case, mesh):
    """One non-streaming and one streaming completion of the case's
    prompt through the HTTP server on rank 0 (over loopback, its
    front-end's driver thread beside it); every other rank follows."""
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.server import (smoke_check,
                                            start_http_server_thread)

    eng = engine_of(job, case, mesh)
    fe = ServingFrontend(eng)
    if not fe.leader:
        fe.follow()
        return {"leader": False}
    fe.start()
    port, stop = start_http_server_thread(fe, model_name="mesh")
    try:
        res = smoke_check("127.0.0.1", port, case["prompt"],
                          max_tokens=case.get("max_new", 10))
    finally:
        stop()
        fe.stop()
    return {"leader": True, "plain": res["non_streaming_tokens"],
            "streamed": res["streamed_tokens"],
            "finish_reason": res["finish_reason"]}


def forward_case(job, case, mesh):
    """Meshed logits of a prefill over ``tokens`` and of one decode step
    after it, on the layout the case names."""
    from repro_torch.core.tp import MeshPlan
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.transformer import forward
    from repro_torch.models.weights import shard_params

    cfg = config(job["configs"][case.get("config", "small")])
    plan = MeshPlan.for_mesh(mesh, case["batch"])
    pt = shard_params(params_of(job, case.get("target", "pt")), cfg, plan)
    toks = torch.tensor(case["tokens"], dtype=torch.int32)
    b, s = toks.shape
    prompt, last = toks[:, :-1], toks[:, -1:]
    out = {}
    if case.get("paged"):
        nb, bs = 8 * b, 16
        cache = cache_lib.paged_cache_struct(cfg, b, 128, nb, bs, plan=plan)
        per = cache["block_table"].shape[1]
        cache["block_table"] = torch.arange(b * per, dtype=torch.int32
                                            ).reshape(b, per)
    else:
        cache = cache_lib.cache_struct(
            cfg, b, 128, plan=plan,
            enc_len=len(case["frames"][0]) if "frames" in case else None)
    if "frames" in case:
        out.update(encoder_context(cfg, pt, plan, cache, case))
    lp, cache = forward(pt, cfg, prompt, cache=cache, mode="prefill",
                        plan=plan)
    cache["length"] = torch.full((b,), s - 1, dtype=torch.int32)
    ld, _ = forward(pt, cfg, last, cache=cache, mode="decode", plan=plan)
    out.update(prefill=lp.numpy(), decode=ld.numpy())
    return out


def encoder_context(cfg, pt, plan, cache, case):
    """An encoder-decoder's context on the mesh: ``encode`` of this
    rank's rows of the case's frames, and ``build_cross_cache`` of the
    reference's encoder output (``renc``) on its shards; the cache then
    decodes over the reference's cross K/V (``rk``/``rv``) cut to this
    rank's rows and KV heads, as the reference test decodes over the
    same values in both packages.  Returns the encoder output, the built
    cross K and the reference's cut cross K."""
    from repro_torch.core import tp
    from repro_torch.models.transformer import (_cache_heads,
                                                build_cross_cache, encode)
    rows = tp.split_rows(cache, plan)
    sl = slice(None) if rows is None else slice(*rows)
    frames, renc = (torch.tensor(case[k])[sl] for k in ("frames", "renc"))
    enc = encode(pt, cfg, frames, plan=plan)
    ck, _ = build_cross_cache(pt, cfg, renc, plan=plan)
    lay = plan.layout(cfg)
    kv, m = cfg.num_kv_heads, plan.model_size
    # the heads this rank projects: its share where model divides them
    mine = (slice(plan.model_rank * kv // m, (plan.model_rank + 1) * kv // m)
            if m > 1 and kv % m == 0 else slice(None))

    def cut(x):
        x = torch.tensor(x)[:, sl, :, mine]
        n, bl, se, h, d = x.shape
        flat = x.reshape(n * bl, se, h, d)
        if lay.real_kv is not None:
            flat = flat[:, :, lay.real_kv]
        flat, _ = _cache_heads(cfg, flat, flat, lay)
        return flat.reshape(n, bl, se, flat.shape[2], d).contiguous()
    cache["cross_k"], cache["cross_v"] = cut(case["rk"]), cut(case["rv"])
    cache["enc_valid"][:] = True
    return {"enc": enc.numpy(), "cross_k": ck.numpy(),
            "cross_k_ref": cache["cross_k"].numpy()}


def layout_case(job, case, mesh):
    """The plan's layout of a config and the local shapes of its params
    and caches (no serve)."""
    from repro_torch.core.tp import MeshPlan
    from repro_torch.models import cache as cache_lib
    from repro_torch.models.weights import init_params

    cfg = config(job["configs"][case["config"]])
    plan = MeshPlan.for_mesh(mesh, case["batch"])
    lay = plan.layout(cfg)
    pt = init_params(cfg, seed=0, device="cpu", plan=plan)
    ring = cache_lib.cache_struct(cfg, case["batch"], 64, plan=plan)
    pool = cache_lib.paged_cache_struct(cfg, case["batch"], 64, 8, 16,
                                        plan=plan)
    return {"layout": dataclasses.asdict(lay),
            "model_rank": plan.model_rank, "data_rank": plan.data_rank,
            "wq": tuple(pt["layers"]["attn"]["wq"].shape),
            "wk": tuple(pt["layers"]["attn"]["wk"].shape),
            "ring_k": tuple(ring["k"].shape),
            "pool_k": tuple(pool["k"].shape)}


KINDS = {"serve": serve, "forward": forward_case, "layout": layout_case,
         "frontend": frontend_case, "http": http_case}


def main(rank, world, store_path, job_path, out_path):
    from repro_torch.launch.mesh import serving_mesh

    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = serving_mesh(job["mesh"], device_type="cpu")
        results = {"seconds": {}}
        for case in job["cases"]:
            t0 = time.monotonic()
            results[case["name"]] = KINDS[case.get("kind", "serve")](
                job, case, mesh)
            results["seconds"][case["name"]] = time.monotonic() - t0
        torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
