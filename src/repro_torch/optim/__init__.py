"""Mixed-precision AdamW."""
