"""MFU of the extraction window: the network's operations at each yielded
utterance's own frames (padding is waste, not work), plus K1's."""

from benchmark.readers import mfu as read  # noqa: F401
