"""The harness: cells, traffic, drivers of the port's entry points, the
trace and the comparison that decides ``correct``."""
