"""Training launcher of the port (``repro.launch.train``).

``--demo`` trains the reduced config of a registered architecture for
``--steps`` steps on the synthetic Markov corpus (the reference's
recipe: peakedness 2.0, a stream of 200 000 tokens, batch 16 x 64, lr
3e-3, warmup 20, clip 5.0), then writes a checkpoint in the reference's
format.  The demo feeds tokens only, so an encoder-decoder
(``seamless-m4t-medium``) raises ``AssertionError`` at its first step,
as the reference's demo does.  It runs on the CUDA card unless
``--device cpu`` is given.  The default mode is the dry run of the
production train_4k step (``launch/dryrun.py``) on the 16 x 16 mesh
(``--multi-pod``: 2 x 16 x 16): per-device FLOPs, bytes, collectives,
memory and the H100 roofline; it needs no card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --demo --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --demo --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b [--multi-pod]
"""
import argparse
import os
import tempfile
from typing import Dict, List, Optional

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import OptimizerConfig, TrainConfig
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import MarkovTaskCorpus, lm_batches
from repro_torch.training.train import train_loop


def main(argv: Optional[List[str]] = None) -> Dict:
    """Runs the demo and returns its metrics and ``checkpoint``, the
    file written; or the dry run and returns its record (exit 1 if it
    failed)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="dry run: the arch's reduced config")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.demo:
        rec = dryrun_one(args.arch, "train_4k", args.multi_pod,
                         reduced=args.reduced)
        if rec["status"] not in ("ok", "skipped"):
            raise SystemExit(1)
        return rec

    cfg = get_config(args.arch).reduced()
    corpus = MarkovTaskCorpus(cfg.vocab_size, peakedness=2.0)
    stream = corpus.stream(200000)
    tc = TrainConfig(
        global_batch_size=16, seq_len=64,
        optimizer=OptimizerConfig(learning_rate=3e-3, warmup_steps=20,
                                  total_steps=args.steps, grad_clip=5.0),
        checkpoint_dir=args.ckpt_dir)
    params, m = train_loop(cfg, tc, lm_batches(stream, 16, 64),
                           num_steps=args.steps, device=args.device)
    f = save_checkpoint(args.ckpt_dir, args.steps, params)
    print(f"final: {m}  checkpoint: {f}")
    return dict(m, checkpoint=f)


if __name__ == "__main__":
    main()
