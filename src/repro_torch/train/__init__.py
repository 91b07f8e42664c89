"""Training: AdamW, the train step, checkpoints and fault tolerance."""
