"""The card's idle share in the traced stretch of training steps."""

from benchmark.readers import idle_share as read  # noqa: F401
