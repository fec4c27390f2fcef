"""`host_ms_per_step.paced_train`: host ms a train step spends inside
`train_superstep`, in a host-paced training cell."""

from benchmark.harness.readers import host_ms_per_step as read  # noqa: F401
