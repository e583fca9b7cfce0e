"""Direct-pose decode."""
