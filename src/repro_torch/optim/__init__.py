"""Mixed-precision AdamW, and QRP gradient compression for the slow group."""
