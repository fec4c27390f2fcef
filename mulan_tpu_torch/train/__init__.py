"""Training: the two-group AdamW, the train state with its EMA, and the
`Experiment` loop."""
