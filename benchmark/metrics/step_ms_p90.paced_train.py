"""`step_ms_p90.paced_train`: the 90th percentile of the step-end CUDA
events' intervals over every step of the window, in a host-paced training
cell."""

from benchmark.harness.readers import step_ms_p90 as read  # noqa: F401
