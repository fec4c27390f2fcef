"""`backward_device_ms_per_step.train`: device ms a train step between the CUDA
events of the program's span `backward`, in a device-bound training cell."""

from benchmark.harness.program import backward_device_ms as read  # noqa: F401
