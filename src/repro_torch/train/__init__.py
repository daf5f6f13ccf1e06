"""The single-device train step."""
