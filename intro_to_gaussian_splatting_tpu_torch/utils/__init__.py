"""Profiling and timing helpers, and the card's ceilings."""
