"""Numpy-only data helpers of the port."""
