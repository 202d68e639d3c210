"""MFU of the training window: forward, margin head and backward of each
completed step, counted on the plain reference, plus K1's."""

from benchmark.readers import mfu as read  # noqa: F401
