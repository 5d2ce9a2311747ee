"""Execution engine: expression evaluation, segments, group-by and sort."""
