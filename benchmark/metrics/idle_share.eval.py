"""`idle_share.eval`: the share of a dense-VLB chunk's time with the device
idle (device time from the trace, wall time from the window), in %."""

from benchmark.harness.readers import idle_share_eval as read  # noqa: F401
