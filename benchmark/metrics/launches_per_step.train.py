"""`launches_per_step.train`: device kernels a train step launches (traced
calls), in a device-bound training cell."""

from benchmark.harness.readers import launches_per_step as read  # noqa: F401
