"""K1's share of its roofline, one launch a train step's batch of chunks."""

from benchmark.readers import k1_roofline as read  # noqa: F401
