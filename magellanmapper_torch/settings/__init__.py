"""Detection and grid-search settings profiles."""
