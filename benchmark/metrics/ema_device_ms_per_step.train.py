"""`ema_device_ms_per_step.train`: device ms a train step between the CUDA
events of the program's span `ema`, in a device-bound training cell."""

from benchmark.harness.program import ema_device_ms as read  # noqa: F401
