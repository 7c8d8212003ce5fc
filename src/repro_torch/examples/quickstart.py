"""Quickstart: DSDE speculative decoding in about 60 lines.

Builds a tiny target/draft pair (seeded random weights, draft = perturbed
target so acceptance is non-trivial), serves a batch of prompts with the
DSDE dynamic-SL policy, and prints the telemetry that matters: block
efficiency, acceptance rate, and per-request outputs.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.config import ServingConfig, SpecDecodeConfig
from repro_torch.models.weights import init_params, map_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a reduced SmolLM-family target + a correlated draft
    cfg = get_config("smollm-135m").reduced()
    params_t = init_params(cfg, seed=1, device=args.device)
    noise = init_params(cfg, seed=7, device=args.device)
    params_d = map_params(lambda a, b: a + 0.03 * b, params_t, noise)

    # 2. the DSDE engine: training-free dynamic SL + adaptive SL cap
    spec = SpecDecodeConfig(policy="dsde", temperature=0.0, use_sl_cap=True)
    serving = ServingConfig(max_batch_size=4, max_seq_len=256)
    engine = ServingEngine(params_t, cfg, params_d, cfg, spec, serving,
                           device=args.device)

    # 3. a heterogeneous batch of requests
    rng = np.random.RandomState(0)
    requests = [
        Request(i, prompt=rng.randint(0, cfg.vocab_size,
                                      size=rng.randint(6, 24)).tolist(),
                max_new_tokens=32)
        for i in range(8)
    ]
    metrics = engine.run(requests)

    # 4. what you get
    print(f"tokens emitted      : {metrics['tokens_emitted']}")
    print(f"verification rounds : {metrics['rounds']}")
    print(f"block efficiency    : {metrics['block_efficiency']:.2f} "
          f"(tokens per target verification)")
    print(f"mean acceptance     : {metrics['mean_acceptance']:.2f}")
    print(f"throughput          : {metrics['throughput_tok_s']:.1f} tok/s "
          f"({metrics['device']}, reduced model)")
    for r in requests[:3]:
        print(f"  request {r.request_id}: {len(r.output)} tokens, "
              f"BE={r.block_efficiency():.2f}, out[:8]={r.output[:8]}")
    return {"dsde": metrics, "streams": [r.output for r in requests]}


if __name__ == "__main__":
    main()
