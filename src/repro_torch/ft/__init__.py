"""Fault tolerance: the serving scheduler's watchdog and the elastic
re-mesh plan."""
