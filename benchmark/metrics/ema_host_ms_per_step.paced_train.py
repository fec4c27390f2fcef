"""`ema_host_ms_per_step.paced_train`: host ms a train step in the program's
span `ema` (the EMA's update), in a host-paced training cell."""

from benchmark.harness.program import ema_host_ms as read  # noqa: F401
