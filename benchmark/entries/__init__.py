"""One driver per entry a traffic mix names, found by that name."""
