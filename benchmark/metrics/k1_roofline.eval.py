"""`k1_roofline.eval`: K1's share of its roofline: the least time of the
attention the program counted in the traced calls over K1's device time
there, in %."""

from benchmark.harness.program import k1_roofline as read  # noqa: F401
