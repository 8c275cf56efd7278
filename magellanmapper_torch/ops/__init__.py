"""Device primitives: filters and the LoG pyramid, preprocessing, peaks."""
