"""`forward_host_ms_per_step.paced_train`: host ms a train step in the program's
span `forward` (the loss's dispatch), in a host-paced training cell."""

from benchmark.harness.program import forward_host_ms as read  # noqa: F401
