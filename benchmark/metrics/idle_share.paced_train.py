"""`idle_share.paced_train`: the share of a train step's time with the device
idle (device time from the trace, wall time from the window), in %, in a
host-paced training cell."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
