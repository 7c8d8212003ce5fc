"""Async serving front-end demo (DESIGN.md §14): token streaming,
open-loop trace replay, and the replay-at-zero exactness check.

Three acts over one continuous-batching front-end
(``repro_torch.serving.frontend``) wrapping the pipelined engine on the
paged pool:

1. **Streaming**: requests submitted from the caller's thread against
   the live driver thread; each consumer iterates its
   :class:`StreamHandle` and sees tokens the moment the host reconciles
   them.
2. **Trace replay**: a seeded bursty trace
   (``repro_torch.serving.loadgen``) replayed open-loop at its arrival
   offsets, reporting TTFT/TPOT percentiles, queue depth, and goodput.
3. **Exactness**: the same trace with every arrival at t=0 must produce
   byte-identical streams to a direct ``ServingEngine.run()``.

Run:  PYTHONPATH=src python -m repro_torch.examples.stream_serving [--device cpu]
      (first run trains the pair; cached afterwards)

      PYTHONPATH=src python -m repro_torch.examples.stream_serving --smoke
      (untrained pair, tiny trace)

For the HTTP layer over this same front-end, see
``python -m repro_torch.launch.serve --http`` (OpenAI-compatible, SSE).
"""
import argparse
import threading
from typing import Dict, List, Optional

from repro_torch import workloads
from repro_torch.core.config import ServingConfig, SpecDecodeConfig
from repro_torch.serving import loadgen
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.frontend import ServingFrontend


def make_engine(cfg_t, cfg_d, pt, pd, device):
    """The demo's engine: dsde on the fp32 pool in blocks of 16,
    pipelined, batch 4, 256 tokens."""
    spec = SpecDecodeConfig(policy="dsde", sf_normalize=True)
    sv = ServingConfig(max_batch_size=4, max_seq_len=256, paged_kv=True,
                       kv_block_size=16, pipelined=True)
    return ServingEngine(pt, cfg_t, pd, cfg_d, spec, sv, seed=0,
                         device=device)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="untrained pair + tiny trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device

    label = "untrained (smoke)" if args.smoke else "trained (cached)"
    print(f"== building target/draft pair: {label} ==")
    if args.smoke:
        cfg_t, cfg_d, pt, pd, _ = workloads.untrained_pair(device)
        n_req, max_new = 6, 8
    else:
        cfg_t, cfg_d, pt, pd, _ = workloads.build_pair("llama", device)
        n_req, max_new = 12, 24

    def engine():
        return make_engine(cfg_t, cfg_d, pt, pd, device)

    # -- act 1: live token streaming ------------------------------------
    print("\n== streaming: consumers see tokens as rounds reconcile ==")
    fe = ServingFrontend(engine()).start()
    prompts = workloads.dataset("dialogue").prompts(3, 12, seed=4)
    handles = [fe.submit(p, max_new_tokens=max_new) for p in prompts]
    lines = {}

    def _consume(i, handle):
        lines[i] = list(handle)         # blocks until each token lands

    threads = [threading.Thread(target=_consume, args=(i, h))
               for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, h in enumerate(handles):
        print(f"  req {i}: {len(lines[i])} tokens streamed, "
              f"finish={h.request.finish_reason()}  "
              f"ttft={h.request.ttft() * 1e3:.0f}ms")
        if lines[i] != h.request.output:
            raise AssertionError(f"request {i}: streamed tokens differ "
                                 "from its output")
    fe.stop()
    out = {"streaming": fe.summary()}

    # -- act 2: open-loop bursty trace replay ---------------------------
    print("\n== trace replay: bursty arrivals, open loop ==")
    trace = loadgen.make_trace(n_req, rate_rps=4.0, process="bursty",
                               seed=13, max_new_cap=max_new)
    fe = ServingFrontend(engine()).start()
    try:
        point = loadgen.replay(fe, trace)
    finally:
        fe.stop()
    print(f"  finished {point['requests_finished']}/{point['requests']} "
          f"({point['tokens_emitted']} tokens) in {point['wall_s']:.2f}s")
    print(f"  ttft p50/p99 = {point['ttft_s_p50'] * 1e3:.0f}/"
          f"{point['ttft_s_p99'] * 1e3:.0f} ms   "
          f"tpot p50 = {point['tpot_s_p50'] * 1e3:.0f} ms")
    print(f"  queue depth peak = {point['queue_depth_peak']:.0f}   "
          f"goodput = {point['goodput_tok_s']:.1f} tok/s "
          f"(SLO-attained {point['slo_attained_frac']:.0%})")
    out["replay"] = {**fe.summary(), "report": point}

    # -- act 3: replay-at-zero == run() ---------------------------------
    print("\n== exactness: replay at t=0 vs direct run() ==")
    ref = loadgen.trace_requests(trace)
    engine().run(ref)
    fe = ServingFrontend(engine())
    reqs = loadgen.trace_requests(trace)
    for r in reqs:
        fe.submit_request(r)
    fe.run_until_drained()
    if [r.output for r in reqs] != [r.output for r in ref]:
        raise AssertionError("front-end replay diverged from run()")
    print("  token streams byte-identical: OK")
    out["replay_at_zero"] = fe.summary()
    return out


if __name__ == "__main__":
    main()
