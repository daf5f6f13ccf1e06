"""AdamW with learning-rate schedules, structured and flat."""
