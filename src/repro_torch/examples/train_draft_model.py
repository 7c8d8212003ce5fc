"""Train a draft model for a few hundred steps on the synthetic task
mixture, checkpoint it, and measure how its acceptance rate against the
cached target improves with training: the training substrate (data
pipeline, AdamW, checkpointing) end to end.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_draft_model [--device cpu]
"""
import argparse
import os
import tempfile
from typing import Dict, List, Optional

from repro_torch import workloads
from repro_torch.core.config import OptimizerConfig, TrainConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import lm_batches
from repro_torch.training.train import train_loop

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_example_draft")
STEPS = (40, 120, 250)   # each a training of its own from the seeded init


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg_t, _, pt, _, _ = workloads.build_pair("llama", device=args.device)
    cfg_d = workloads.draft_config()
    stream = workloads.mixed_stream()
    prompts = workloads.dataset("code").prompts(6, 12, seed=1)

    pd, out = None, {}
    for steps in STEPS:
        tc = TrainConfig(global_batch_size=16, seq_len=64,
                         optimizer=OptimizerConfig(learning_rate=3e-3,
                                                   warmup_steps=20,
                                                   total_steps=steps,
                                                   grad_clip=5.0))
        pd, m = train_loop(cfg_d, tc, lm_batches(stream, 16, 64, seed=11),
                           num_steps=steps, verbose=False, seed=11,
                           device=args.device)
        res, _, _ = workloads.serve(cfg_t, cfg_d, pt, pd, prompts,
                                    policy="static", static_sl=4,
                                    device=args.device)
        print(f"draft @ {steps:3d} steps: loss={m['loss']:.3f}  "
              f"acceptance={res['mean_acceptance']:.2f}  "
              f"BE={res['block_efficiency']:.2f}")
        out[f"static@{steps}"] = {**res, "loss": m["loss"]}

    path = save_checkpoint(CKPT_DIR, STEPS[-1], pd)
    print(f"checkpointed trained draft to {path}")
    return out


if __name__ == "__main__":
    main()
