"""Training: the two-group AdamW, the train state with its EMA, its
checkpoints, and the `Experiment` loop."""
