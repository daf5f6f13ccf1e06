"""Launchers (``serve``, ``train``) and their process environment (``env``)."""
