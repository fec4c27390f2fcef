"""`kernel_ms_per_step.train`: device kernel ms a train step (traced calls),
in a device-bound training cell."""

from benchmark.harness.readers import kernel_ms_per_step as read  # noqa: F401
