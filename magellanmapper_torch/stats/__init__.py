"""Statistics: the detection grid search."""
