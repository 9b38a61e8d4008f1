"""The synthetic token pipeline (numpy only)."""
