"""`k6_roofline.paced_train`: K6's share of its roofline: the least time of the
masks the program counted in the traced calls over the dropout masks' device
time there, in %, in a host-paced training cell."""

from benchmark.harness.program import k6_roofline as read  # noqa: F401
