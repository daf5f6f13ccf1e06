"""Serving: ``engine`` (continuous batching and the lockstep loop),
``scheduler`` (with the failure model), ``paged`` (page pool), ``prefix``
(radix prefix cache), ``graphs`` (the captured decode step), ``faults``
(seeded wire-page fault injection)."""
