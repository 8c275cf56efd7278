"""Host-side utilities copied from the reference package."""
