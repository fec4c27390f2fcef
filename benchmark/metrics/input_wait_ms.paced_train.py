"""`input_wait_ms.paced_train`: host ms a train step waits in
`next(train_iter)`, in a host-paced training cell."""

from benchmark.harness.readers import input_wait_ms as read  # noqa: F401
