"""Data generators and reference queries."""
