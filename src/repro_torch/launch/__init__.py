"""Launchers (``serve``, ``train``), their process environment (``env``)
and the meshes of a launched job (``mesh``)."""
