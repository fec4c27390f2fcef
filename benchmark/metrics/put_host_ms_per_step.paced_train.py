"""`put_host_ms_per_step.paced_train`: host ms a train step in the program's
span `put` (the super-batch's copy to the card), in a host-paced training
cell."""

from benchmark.harness.program import put_host_ms as read  # noqa: F401
