"""Detection, grid-search and atlas (registration) settings profiles."""
