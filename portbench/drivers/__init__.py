"""Serving loops, one module per traffic mix's `driver`."""
