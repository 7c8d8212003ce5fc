"""Training: token corpora, AdamW, the train step and loop, checkpoints."""
