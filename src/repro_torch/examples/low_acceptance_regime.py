"""Paper §4.4 at miniature scale: the low-acceptance (Gemma-27B/2B-like)
regime.

A weak, divergently-trained draft makes speculation barely worthwhile
(k_opt collapses toward 2).  The example shows what the paper shows:
entropy-driven adaptation (AdaEDL) degrades, while the post-hoc KLD/WVIR
signal keeps DSDE near the static optimum.

Run:  PYTHONPATH=src python -m repro_torch.examples.low_acceptance_regime [--device cpu]
"""
import argparse
from typing import Dict, List, Optional

from repro_torch import workloads


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device

    out = {}
    for regime in ("llama", "gemma"):
        print(f"== {regime} pair "
              f"({'strong draft' if regime == 'llama' else 'weak, divergent draft'}) ==")
        cfg_t, cfg_d, pt, pd, ratio = workloads.build_pair(regime, device)
        prompts = []
        for name in ("code", "news", "dialogue"):
            prompts += workloads.dataset(name).prompts(3, 16, seed=4)

        sl_opt, lu_opt, m_opt = workloads.static_opt(
            cfg_t, cfg_d, pt, pd, prompts, ratio, 0.0, device=device)
        print(f"  static-opt: k_opt={sl_opt} latency_units={lu_opt:.1f} "
              f"acceptance={m_opt['mean_acceptance']:.2f}")
        out[f"{regime}/static-opt"] = {**m_opt, "latency_units": lu_opt,
                                       "k_opt": sl_opt}
        for policy in ("dsde", "adaedl"):
            m, _, _ = workloads.serve(cfg_t, cfg_d, pt, pd, prompts,
                                      policy=policy, device=device)
            lu = workloads.latency_units(m, ratio)
            print(f"  {policy:8s}: latency_units={lu:.1f} "
                  f"(+{(lu / lu_opt - 1) * 100:.0f}% vs static-opt) "
                  f"acceptance={m['mean_acceptance']:.2f} "
                  f"BE={m['block_efficiency']:.2f}")
            out[f"{regime}/{policy}"] = {**m, "latency_units": lu}
    return out


if __name__ == "__main__":
    main()
