"""Range-view projection and per-pixel geometry."""
