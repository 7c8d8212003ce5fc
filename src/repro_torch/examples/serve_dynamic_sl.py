"""End-to-end serving driver: take a trained target/draft pair, then
serve a heterogeneous request stream with continuous batching, comparing
every registered SL policy (the goodput controller and the SLO-aware
policy included).

This is the paper's full pipeline at miniature scale: training-free
calibration, per-sequence per-iteration SL from KLD-variance stability
(WVIR), and the adaptive SL cap against stragglers.  Both engine
schedules run: the synchronous lockstep loop and the plan -> dispatch ->
collect pipeline (DESIGN.md §7), which must emit byte-identical greedy
streams; with no deadlines set the ``slo`` policy must emit ``dsde``'s.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_dynamic_sl [--device cpu]
      (first run trains the pair; cached afterwards, ``workloads.CACHE_DIR``)

      PYTHONPATH=src python -m repro_torch.examples.serve_dynamic_sl --smoke
      (untrained pair, tiny mix)
"""
import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch import workloads
from repro_torch.core.drafters import available_drafters


def build_pair(smoke: bool, device):
    return (workloads.untrained_pair(device) if smoke
            else workloads.build_pair("llama", device))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="untrained pair + tiny mix")
    ap.add_argument("--drafter", default="model",
                    choices=list(available_drafters()),
                    help="proposer for every policy row (DESIGN.md §9); "
                         "model-free drafters serve with ZERO draft "
                         "params and zero draft KV blocks")
    ap.add_argument("--prefix-share", type=float, default=0.0, metavar="S",
                    help="fraction in [0,1) of every prompt that is a "
                         "common head; >0 serves on the paged pool with "
                         "prefix caching on (DESIGN.md §12) and reports "
                         "the hit/COW telemetry per policy")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="paged-pool storage mode (DESIGN.md §13): int8 "
                         "serves off the quantized block pool, same "
                         "block count, under half the KV bytes (implies "
                         "the paged data plane)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not 0.0 <= args.prefix_share < 1.0:
        ap.error("--prefix-share must be in [0, 1)")
    device = args.device

    label = "untrained (smoke)" if args.smoke else "trained (cached)"
    print(f"== building target/draft pair: {label} ==")
    cfg_t, cfg_d, pt, pd, ratio = build_pair(args.smoke, device)
    print(f"   draft/target FLOP ratio: {ratio:.3f}")
    print(f"   drafter: {args.drafter}")

    # heterogeneous workload: code-like + dialogue-like requests interleaved
    per = 2 if args.smoke else 4
    max_new = 12 if args.smoke else 48
    prompts = []
    for i, name in enumerate(workloads.DATASETS):
        prompts += workloads.dataset(name).prompts(per, 16, seed=42 + i)
    rng = np.random.RandomState(0)
    rng.shuffle(prompts)

    paged_kw = {}
    batch = 8
    if args.prefix_share > 0:
        # half the slots: the first admission wave is cold (it *creates*
        # the cache entries), later waves hit the registered head; with
        # batch >= len(prompts) every request admits cold simultaneously
        batch = 4
        # shared head sized so head/(head+tail) ~= share, block-aligned
        # so full blocks are hashable (DESIGN.md §12)
        bs, tail = 16, 16
        head_len = int(round(args.prefix_share
                             / (1 - args.prefix_share) * tail))
        head_len = max(head_len // bs * bs, bs)
        head = workloads.dataset("code").prompts(1, head_len, seed=7)[0]
        prompts = [head + p for p in prompts]
        paged_kw = dict(paged=True, kv_block_size=bs, prefix_caching=True)
        print(f"== prefix share {args.prefix_share:.2f}: common head of "
              f"{head_len} tokens, paged pool + prefix caching on ==")
    if args.kv_quant != "none":
        paged_kw.update(paged=True, kv_quant=args.kv_quant)
        paged_kw.setdefault("kv_block_size", 16)
        print(f"== kv_quant {args.kv_quant}: int8 block pool, dequant "
              "fused into the verify kv-sweep (DESIGN.md §13) ==")

    def serve(policy, **kw):
        return workloads.serve(cfg_t, cfg_d, pt, pd, prompts, policy=policy,
                               max_new=max_new, batch=batch,
                               drafter=args.drafter, device=device,
                               **paged_kw, **kw)

    print(f"== serving {len(prompts)} requests, batch={batch}, "
          f"max_new={max_new} ==")
    print(f"{'policy':16s} {'rounds':>7s} {'BE':>6s} {'accept':>7s} "
          f"{'latency_units':>14s} {'speedup':>8s}")
    lu_ar = None
    # model drafter: the pair's emulated cost ratio; model-free
    # drafters let the engine source the cost from Drafter.step_cost()
    cost_kw = ({"goodput_draft_cost": ratio}
               if args.drafter == "model" else {})
    out, streams = {}, {}
    for policy in ("autoregressive", "static", "adaedl", "dsde", "goodput",
                   "slo"):
        m, reqs, _ = serve(policy, **cost_kw)
        lu = workloads.latency_units(
            m, ratio if args.drafter == "model" else m["draft_step_cost"])
        if policy == "autoregressive":   # the speedup baseline row
            lu_ar = lu
        cache = ""
        if args.prefix_share > 0:
            cache = (f"  hit_rate={m['prefix_cache_hit_rate']:.2f} "
                     f"hit_blocks={m['prefix_cache_hit_blocks']:.0f} "
                     f"cow={m['cow_copies']:.0f}")
        print(f"{policy:16s} {m['rounds']:7d} {m['block_efficiency']:6.2f} "
              f"{m['mean_acceptance']:7.2f} {lu:14.1f} "
              f"{lu_ar / lu:7.2f}x{cache}")
        out[policy] = {**m, "latency_units": lu}
        streams[policy] = [r.output for r in reqs]
    # "slo" rides with no deadlines set, so its row must equal dsde's:
    # the DESIGN.md §15 no-deadline exactness bar
    if streams["slo"] != streams["dsde"] or any(
            out["slo"][k] != out["dsde"][k]
            for k in ("rounds", "draft_steps", "tokens_emitted")):
        raise AssertionError("slo with no deadlines must serve as dsde")

    print("\n== sync vs pipelined schedule (dsde, identical streams) ==")
    sched = {}
    for pipelined in (False, True):
        m, reqs, _ = serve("dsde", pipelined=pipelined)
        mode = "pipelined" if pipelined else "sync"
        sched[mode] = [r.output for r in reqs]
        print(f"  {mode:9s}: wall={m['wall_time_s']:.2f}s "
              f"rounds={m['rounds']} "
              f"host_blocked/round={m['host_blocked_per_round_s'] * 1e3:.1f}ms "
              f"ttft_mean={m['ttft_mean_s'] * 1e3:.0f}ms "
              f"queue_wait={m['queue_wait_mean_s'] * 1e3:.0f}ms")
        out[f"dsde-{mode}"] = m
    if sched["sync"] != sched["pipelined"]:
        raise AssertionError("schedules must not change tokens")
    print("  token streams byte-identical across schedules: OK")

    print("\n== DSDE per-round dynamics (first 12 rounds) ==")
    _, _, eng = serve("dsde")
    for i, r in enumerate(eng.round_log[:12]):
        print(f"  round {i:2d}: K={r['k']} emitted={r['emitted']:.0f} "
              f"accepted={r['accepted']:.0f}/{r['proposed']:.0f}")
    out["streams"] = streams
    return out


if __name__ == "__main__":
    main()
