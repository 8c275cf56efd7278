"""Detection: single-block LoG detection and whole-stack block detection."""
