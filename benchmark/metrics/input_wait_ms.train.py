"""`input_wait_ms.train`: host ms a train step waits in `next(train_iter)`,
in a device-bound training cell."""

from benchmark.harness.readers import input_wait_ms as read  # noqa: F401
