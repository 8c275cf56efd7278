"""Statistics: the detection grid search, per-region metrics and
cluster counts."""
