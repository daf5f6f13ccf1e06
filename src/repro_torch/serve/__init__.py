"""Paged continuous-batching serving: ``engine``, ``scheduler``,
``paged`` (page pool), ``prefix`` (radix prefix cache)."""
