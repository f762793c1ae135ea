"""Evaluation protocol of the port: evaluator, index generator, offline
metric computer."""

from . import evaluator, index_generator  # noqa: F401
