"""`kernel_ms_per_step.paced_train`: device kernel ms a train step (traced
calls), in a host-paced training cell."""

from benchmark.harness.readers import kernel_ms_per_step as read  # noqa: F401
