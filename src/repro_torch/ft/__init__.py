"""Fault tolerance: the serving scheduler's watchdog."""
