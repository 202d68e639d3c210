"""K1's share of its roofline, one launch a padded extraction batch."""

from benchmark.readers import k1_roofline as read  # noqa: F401
