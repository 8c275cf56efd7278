"""Atlas registration: transforms, similarity metrics, the optimizer
engine, the single-sample ``--register`` task and its synthetic
ground-truthed fixture; the whole-image transform and the label
ontology."""
