"""Fault-tolerance runtime: retries, failure injection, liveness, stragglers."""
