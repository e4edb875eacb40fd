"""Training: the deterministic data stream, AdamW, the train step,
checkpoints and the fault-tolerance hooks."""
