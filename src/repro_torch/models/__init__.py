"""Dense decoder model: ``layers``, ``transformer``, ``model``."""
