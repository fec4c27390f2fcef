"""`launches_per_step.paced_train`: device kernels a train step launches
(traced calls), in a host-paced training cell."""

from benchmark.harness.readers import launches_per_step as read  # noqa: F401
