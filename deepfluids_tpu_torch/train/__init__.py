"""Serving subset of the JAX ``train`` package: ``apply_curl`` and the
``Trainer`` that builds, loads and runs the arch "de" generator."""
